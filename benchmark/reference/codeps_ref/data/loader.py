"""Batch assembly and the loader's order of an epoch.

Counterpart of ``codeps_tpu/data/loader.py`` (the reference's torch
``DataLoader`` + ``collate_batch``, ``misc/train_utils.py:81-190``):
``collate_batch`` stacks the samples into the canonical NHWC batch dict;
``DataLoader`` keeps the loader's shuffled index order and its length.
Batches are numpy; the caller moves them to the device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


def collate_batch(samples: List[Dict[str, Any]],
                  offsets: Sequence[int] = (1,)) -> Dict[str, np.ndarray]:
    """List of dataset samples -> canonical batch dict.

    Output keys (all NHWC, frame axis = [t, t-1, t+1, ...]):
      frames (B, 1+2*len(offsets), H, W, 3), camera (B, 4),
      semantic/semantic_weights/thing_mask (B, H, W),
      center/center_weights (B, H, W, 1), offset/offset_weights (B, H, W, 2|1),
      depth_gt (B, H, W) when present, instance (B, H, W) when present.
    uint8 frames stay uint8 (normalized on the device), others are float32.
    """
    first = samples[0]
    batch: Dict[str, Any] = {}

    frame_offsets = [0]
    for offset in offsets:
        frame_offsets += [-offset, offset]
    frames = np.stack([
        np.stack([sample["rgb"][o] for o in frame_offsets])
        for sample in samples
    ])
    batch["frames"] = frames if frames.dtype == np.uint8 \
        else frames.astype(np.float32)
    batch["camera"] = np.stack(
        [np.asarray(sample["camera_model"], np.float32)
         for sample in samples])

    def stack(key, dtype):
        if key in first:
            batch[key] = np.stack(
                [np.asarray(sample[key]) for sample in samples]).astype(dtype)

    stack("semantic", np.int32)
    stack("semantic_eval", np.int32)
    stack("semantic_weights", np.float32)
    stack("center", np.float32)
    stack("center_weights", np.float32)
    stack("offset", np.float32)
    stack("offset_weights", np.float32)
    stack("thing_mask", np.int32)
    stack("instance", np.int32)
    if "depth" in first:
        batch["depth_gt"] = np.stack(
            [np.asarray(sample["depth"]) for sample in samples]).astype(
                np.float32)
    return batch


class DataLoader:
    """The shuffled order of a loader over a dataset. With
    ``num_shards`` > 1 each shard (one per process of a data-parallel run)
    takes every ``num_shards``-th index, the index list wrapped to a
    common length first, as torch's ``DistributedSampler`` does.
    """

    def __init__(self, dataset, batch_size: int, offsets: Sequence[int],
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.offsets = list(offsets)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(indices)
        # equal shard lengths: a shard with one batch more would run a step
        # whose collectives the others never join
        if self.num_shards > 1 and len(indices) > 0:
            total = -(-len(indices) // self.num_shards) * self.num_shards
            indices = np.resize(indices, total)
            return indices[self.shard_index::self.num_shards]
        return indices

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size
