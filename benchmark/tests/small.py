"""Cells at a size a CPU test can hold: the cell's own files, with the
feed sizes, the encoder's depth, the sequence and the loader cut down."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import configs

SMALL = {
    "adapt_kitti360_r101": {
        "dataset.feed_img_size": [64, 192],
        "adapt.source_dataset.feed_img_size": [64, 128],
        "adapt.replay_buffer.target_size": 4,
        "model.po_depth_net.params.nof_layers": 18,
    },
    "pretrain_cityscapes_r101": {
        "dataset.feed_img_size": [64, 128],
        "train.batch_size_per_gpu": 2,
        "train.nof_workers_per_gpu": 0,
        "model.po_depth_net.params.nof_layers": 18,
    },
}
SMALL_TRAFFIC = {
    "stream": {"stream_frames": 8, "replay_prefill": 4, "source_images": 6},
    "pretrain": {"epoch_items": 24},
}


def small_cell(name: str, values=None) -> dict:
    cell = copy.deepcopy(configs.cell(name))
    cell["config"]["values"].update(SMALL[cell["config"]["name"]])
    cell["config"]["values"].update(values or {})
    cell["traffic"].update(SMALL_TRAFFIC[cell["traffic"]["driver"]])
    return cell


def run_small(name, seed=1, seconds=1.0, trace=False, values=None,
              **kwargs):
    """The cell's driver on the CPU at the small size; ``values`` set
    further configuration keys."""
    import importlib
    cell = small_cell(name, values)
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    torch.set_num_threads(2)
    return cell, driver.run(cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter,
                            **kwargs)
