from codeps_torch.evaluation.depth_metrics import (
    METRIC_KEYS, compute_depth_metrics, compute_depth_metrics_per_class)
from codeps_torch.evaluation.meters import (AverageMeter,
                                            ConfusionMatrixMeter,
                                            ConstantMeter, PanopticMeter)
from codeps_torch.evaluation.panoptic_metrics import (PanopticEvaluator,
                                                      PQStat,
                                                      compute_panoptic_stats)
from codeps_torch.evaluation.semantic_metrics import (
    compute_confusion_matrix, compute_sem_miou)

__all__ = ["METRIC_KEYS", "compute_depth_metrics",
           "compute_depth_metrics_per_class", "AverageMeter",
           "ConfusionMatrixMeter", "ConstantMeter", "PanopticMeter",
           "PanopticEvaluator", "PQStat", "compute_panoptic_stats",
           "compute_confusion_matrix", "compute_sem_miou"]
