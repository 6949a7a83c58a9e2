from codeps_torch.evaluation.depth_metrics import (METRIC_KEYS,
                                                   compute_depth_metrics)
from codeps_torch.evaluation.semantic_metrics import (
    compute_confusion_matrix, compute_sem_miou)

__all__ = ["METRIC_KEYS", "compute_depth_metrics",
           "compute_confusion_matrix", "compute_sem_miou"]
