from benchmark.reference.codeps_ref.data import labels
from benchmark.reference.codeps_ref.data.labels import (get_labels, num_classes, stuff_classes,
                                      thing_classes)

__all__ = ["labels", "get_labels", "num_classes", "stuff_classes",
           "thing_classes"]
