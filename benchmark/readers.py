"""The port's KITTI-360 and Cityscapes readers on seeded in-memory frames
(``synth.py``): only ``_read``, the file decoding, is replaced; label
decoding, center and offset ground truth, augmentation and normalization
are the readers' own. Module-level classes, so that the loader's spawned
workers unpickle them."""

from __future__ import annotations

from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.dataset import Dataset
from codeps_torch.data.kitti_360 import Kitti360

from benchmark import synth


class MemoryCityscapes(Cityscapes):

    def __init__(self, cfg_dataset, mode, count, seed, stream):
        synth.cityscapes_init(self, Dataset.__init__, cfg_dataset, mode,
                              count, seed, stream)

    def _read(self, index, with_labels):
        return synth.cityscapes_read(self, index, with_labels)


class MemoryKitti360(Kitti360):

    def __init__(self, cfg_dataset, count, seed, stream):
        synth.kitti360_init(self, Dataset.__init__, cfg_dataset, count, seed,
                            stream)

    def _read(self, index, with_labels):
        return synth.kitti360_read(self, index, with_labels)
