"""The frozen copy's Cityscapes reader on the benchmark's seeded frames
(``benchmark/synth.py``): the reference works a pretraining batch out
again from the same raw frames and the same augmentation seeds."""

from __future__ import annotations

from benchmark import synth
from benchmark.reference.codeps_ref.data.cityscapes import Cityscapes
from benchmark.reference.codeps_ref.data.dataset import Dataset


class MemoryCityscapes(Cityscapes):

    def __init__(self, cfg_dataset, mode, count, seed, stream):
        synth.cityscapes_init(self, Dataset.__init__, cfg_dataset, mode,
                              count, seed, stream)

    def _read(self, index, with_labels):
        return synth.cityscapes_read(self, index, with_labels)
