"""Batch assembly and a prefetching loader.

Counterpart of ``codeps_tpu/data/loader.py`` (the reference's torch
``DataLoader`` + ``collate_batch``, ``misc/train_utils.py:81-190``): a
producer thread, or worker processes, run the dataset's ``__getitem__``;
``collate_batch`` stacks the samples into the canonical NHWC batch dict;
a bounded queue keeps a few batches ready. Batches are numpy; the caller
moves them to the device.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import random
import threading
from typing import Any, Dict, Iterator, List, Sequence

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


# ---- worker processes: the reference's DataLoader(num_workers=N) with its
# worker_init_fn. The random generators are seeded per batch, not per
# worker, so the augmentation's draws do not depend on which worker takes
# which batch. Workers are spawned (a fork of a process that runs torch's
# threads is unsafe); the dataset reaches them pickled.
_WORKER_STATE: Dict[str, Any] = {}


def _mp_worker_init(dataset, offsets) -> None:
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["offsets"] = offsets


def _mp_fetch_batch(task) -> Dict[str, np.ndarray]:
    batch_indices, seed = task
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    dataset = _WORKER_STATE["dataset"]
    samples = [dataset[int(i)] for i in batch_indices]
    return collate_batch(samples, _WORKER_STATE["offsets"])


class DataLoader:
    """Shuffling, prefetching loader over a dataset.

    ``num_workers > 0`` assembles batches in worker processes;
    ``num_workers == 0`` in one producer thread of this process. With
    ``num_shards`` > 1 each shard (one per process of a data-parallel run)
    takes every ``num_shards``-th index, the index list wrapped to a
    common length first, as torch's ``DistributedSampler`` does.
    """

    def __init__(self, dataset, batch_size: int, offsets: Sequence[int],
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, shard_index: int = 0,
                 num_shards: int = 1, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.offsets = list(offsets)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        n_batches = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        if self.num_workers > 0:
            yield from self._iter_processes(batches)
            return

        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # a consumer that stops early sets ``stop``; a producer blocked
            # on the full queue would otherwise keep its thread and batches
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch_indices in batches:
                    if stop.is_set():
                        return
                    samples = [self.dataset[int(i)] for i in batch_indices]
                    if not _put(collate_batch(samples, self.offsets)):
                        return
                _put(None)
            except BaseException as exc:  # handed to the consumer
                _put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def _iter_processes(self, batches) -> Iterator[Dict[str, np.ndarray]]:
        ctx = multiprocessing.get_context("spawn")
        pool = ctx.Pool(self.num_workers, initializer=_mp_worker_init,
                        initargs=(self.dataset, self.offsets))

        def task_seed(i: int) -> int:
            # mixes (run seed, epoch, shard, batch) so that no two batches
            # of a run share or correlate their augmentation draws
            seq = np.random.SeedSequence(
                [self.seed, self.epoch, self.shard_index, i])
            return int(seq.generate_state(1)[0])

        # at most ``window`` batches in flight, as the threaded path's
        # bounded queue: a stalled consumer must not buffer an epoch
        window = self.num_workers + self.prefetch
        inflight = []
        try:
            for i, batch in enumerate(batches[:window]):
                inflight.append(pool.apply_async(
                    _mp_fetch_batch, ((batch, task_seed(i)),)))
            # a pool replaces a dead worker but never finishes its task, so
            # an untimed get() would wait forever
            task_timeout = float(os.environ.get(
                "CODEPS_LOADER_TASK_TIMEOUT", "600"))
            for i in range(len(batches)):
                try:
                    result = inflight.pop(0).get(timeout=task_timeout)
                except multiprocessing.TimeoutError:
                    raise RuntimeError(
                        f"loader worker batch timed out after "
                        f"{task_timeout:.0f}s: a worker process likely "
                        "died (out of memory?); raise "
                        "CODEPS_LOADER_TASK_TIMEOUT if batches are "
                        "legitimately slower") from None
                nxt = i + window
                if nxt < len(batches):
                    inflight.append(pool.apply_async(
                        _mp_fetch_batch, ((batches[nxt], task_seed(nxt)),)))
                yield result
        finally:
            pool.terminate()
            pool.join()
