from codeps_torch.losses.instance import (binary_mask_loss, center_loss,
                                          ema_consistency_loss, offset_loss)
from codeps_torch.losses.photometric import (photometric_error,
                                             reconstruction_loss,
                                             reconstruction_loss_semantic,
                                             ssim, ssim_target_stats)
from codeps_torch.losses.semantic import (cross_entropy_per_pixel,
                                          semantic_consistency_loss,
                                          semantic_loss)
from codeps_torch.losses.smoothness import (edge_aware_smoothness_loss,
                                            flow_smoothness_loss,
                                            flow_sparsity_loss)

__all__ = [
    "binary_mask_loss", "center_loss", "ema_consistency_loss",
    "offset_loss", "photometric_error", "reconstruction_loss",
    "reconstruction_loss_semantic", "ssim", "ssim_target_stats",
    "cross_entropy_per_pixel", "semantic_consistency_loss",
    "semantic_loss", "edge_aware_smoothness_loss", "flow_smoothness_loss",
    "flow_sparsity_loss",
]
