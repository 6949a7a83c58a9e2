from benchmark.reference.codeps_ref.losses.instance import (binary_mask_loss, center_loss,
                                          ema_consistency_loss, offset_loss)
from benchmark.reference.codeps_ref.losses.photometric import (photometric_error,
                                             reconstruction_loss,
                                             ssim, ssim_target_stats)
from benchmark.reference.codeps_ref.losses.semantic import (cross_entropy_per_pixel,
                                          semantic_loss)
from benchmark.reference.codeps_ref.losses.smoothness import (edge_aware_smoothness_loss,
                                            flow_smoothness_loss,
                                            flow_sparsity_loss)

__all__ = [
    "binary_mask_loss", "center_loss", "ema_consistency_loss",
    "offset_loss", "photometric_error", "reconstruction_loss",
    "ssim", "ssim_target_stats", "cross_entropy_per_pixel", "semantic_loss", "edge_aware_smoothness_loss", "flow_smoothness_loss",
    "flow_sparsity_loss",
]
