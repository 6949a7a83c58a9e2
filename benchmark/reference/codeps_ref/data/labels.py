"""Label taxonomies.

Two label modes (parity: datasets/codeps_labels.py, datasets/
cityscapes_labels.py, datasets/__init__.py:14-32):

  - 'codeps': 14 classes — 9 stuff [0-8] + 5 things [9-13]; wall is merged
    into building and motorcycle+bicycle into 'two-wheeler'.
  - 'cityscapes': the standard 19 train classes — 11 stuff + 8 things.

``get_labels(remove_classes, mode)`` renumbers train ids after removals.
"""

from __future__ import annotations

import operator
from typing import List, NamedTuple, Tuple


class Label(NamedTuple):
    name: str
    id: int          # original Cityscapes label id
    trainId: int
    category: str
    catId: int
    hasInstances: bool
    ignoreInEval: bool
    color: Tuple[int, int, int]


CODEPS_LABELS = [
    Label("road",          7,  0, "flat",         1, False, False, (128, 64, 128)),
    Label("sidewalk",      8,  1, "flat",         1, False, False, (244, 35, 232)),
    Label("building",     11,  2, "construction", 2, False, False, (70, 70, 70)),
    Label("fence",        13,  3, "construction", 2, False, False, (190, 153, 153)),
    Label("pole",         17,  4, "object",       3, False, False, (153, 153, 153)),
    Label("traffic sign", 20,  5, "object",       3, False, False, (220, 220, 0)),
    Label("vegetation",   21,  6, "nature",       4, False, False, (107, 142, 35)),
    Label("terrain",      22,  7, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",          23,  8, "sky",          5, False, False, (70, 130, 180)),
    Label("person",       24,  9, "human",        6, True,  False, (220, 20, 60)),
    Label("rider",        25, 10, "human",        6, True,  False, (255, 0, 0)),
    Label("car",          26, 11, "vehicle",      7, True,  False, (0, 0, 142)),
    Label("truck",        27, 12, "vehicle",      7, True,  False, (0, 0, 70)),
    Label("two-wheeler",  33, 13, "vehicle",      7, True,  False, (119, 11, 32)),
]

# Standard Cityscapes 19-train-class subset (upstream taxonomy).
CITYSCAPES_LABELS = [
    Label("road",           7,  0, "flat",         1, False, False, (128, 64, 128)),
    Label("sidewalk",       8,  1, "flat",         1, False, False, (244, 35, 232)),
    Label("building",      11,  2, "construction", 2, False, False, (70, 70, 70)),
    Label("wall",          12,  3, "construction", 2, False, False, (102, 102, 156)),
    Label("fence",         13,  4, "construction", 2, False, False, (190, 153, 153)),
    Label("pole",          17,  5, "object",       3, False, False, (153, 153, 153)),
    Label("traffic light", 19,  6, "object",       3, False, False, (250, 170, 30)),
    Label("traffic sign",  20,  7, "object",       3, False, False, (220, 220, 0)),
    Label("vegetation",    21,  8, "nature",       4, False, False, (107, 142, 35)),
    Label("terrain",       22,  9, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",           23, 10, "sky",          5, False, False, (70, 130, 180)),
    Label("person",        24, 11, "human",        6, True,  False, (220, 20, 60)),
    Label("rider",         25, 12, "human",        6, True,  False, (255, 0, 0)),
    Label("car",           26, 13, "vehicle",      7, True,  False, (0, 0, 142)),
    Label("truck",         27, 14, "vehicle",      7, True,  False, (0, 0, 70)),
    Label("bus",           28, 15, "vehicle",      7, True,  False, (0, 60, 100)),
    Label("train",         31, 16, "vehicle",      7, True,  False, (0, 80, 100)),
    Label("motorcycle",    32, 17, "vehicle",      7, True,  False, (0, 0, 230)),
    Label("bicycle",       33, 18, "vehicle",      7, True,  False, (119, 11, 32)),
]


def get_labels(remove_classes: List[int], mode: str) -> List[Label]:
    """Renumbered label list after class removal (datasets/__init__.py:14-32)."""
    if mode == "cityscapes":
        labels = [l for l in CITYSCAPES_LABELS if l.trainId not in (-1, 255)]
    elif mode == "codeps":
        labels = [l for l in CODEPS_LABELS if l.trainId not in (-1, 255)]
    else:
        raise ValueError(f"Unsupported label mode: {mode}")
    labels = sorted(labels, key=operator.attrgetter("trainId"))

    train_id = 0
    adapted = []
    for label in labels:
        if label.trainId in remove_classes:
            continue
        adapted.append(label._replace(trainId=train_id))
        train_id += 1
    return adapted


def stuff_classes(label_mode: str, remove_classes: List[int]) -> List[int]:
    """Stuff train-id list after removals (datasets/dataset.py:196-209)."""
    if label_mode == "codeps":
        class_list = list(range(9))
    elif label_mode == "cityscapes":
        class_list = list(range(11))
    else:
        raise ValueError(f"Unsupported label mode: {label_mode}")
    count = sum(1 for cls in remove_classes if cls in class_list)
    return class_list[:-count] if count > 0 else class_list


def thing_classes(label_mode: str, remove_classes: List[int]) -> List[int]:
    """Thing train-id list after removals (datasets/dataset.py:211-229)."""
    if label_mode == "codeps":
        class_list = list(range(9, 14))
    elif label_mode == "cityscapes":
        class_list = list(range(11, 19))
    else:
        raise ValueError(f"Unsupported label mode: {label_mode}")
    count_thing = sum(1 for cls in remove_classes if cls in class_list)
    count_stuff = len(remove_classes) - count_thing
    class_list = [c - count_stuff for c in class_list]
    return class_list[:-count_thing] if count_thing > 0 else class_list


def num_classes(label_mode: str, remove_classes: List[int]) -> int:
    return (len(stuff_classes(label_mode, remove_classes))
            + len(thing_classes(label_mode, remove_classes)))
