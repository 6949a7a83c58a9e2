from benchmark.reference.codeps_ref.evaluation.depth_metrics import (
    METRIC_KEYS, compute_depth_metrics, compute_depth_metrics_per_class)
from benchmark.reference.codeps_ref.evaluation.semantic_metrics import (
    compute_confusion_matrix)

__all__ = ["METRIC_KEYS", "compute_depth_metrics",
           "compute_depth_metrics_per_class", "compute_confusion_matrix"]
