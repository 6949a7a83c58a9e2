"""The replay buffer's draws of the stream's first frames, worked out again.

Each adapted frame takes from the buffer two source samples (drawn
exhaust-before-repeat from the source buffer, histogram-matched to the
frame, colour-jittered and normalized), two replayed target frames and the
raw materials of its mixups; the runner draws the cut cells. All of that
follows from seeded generators: the buffer's ``random.Random(seed)`` for
the augmentations and its three samplers and the runner's mixup generator,
each seeded from ``adapt.replay_sampler.seed``. The number of draws of
each item does not depend on the frames, so this module makes them in the
buffer's order and works each sample out again from the benchmark's
generator (``synth.py``) with the frozen copy's reader and preprocessing:
the source domain, the cut cells, and each mixup's source, labels and
target where that target is the streamed frame.

Not worked out again: which frames a replay draws and what is drawn from
them (the target buffer's contents follow the port's features and the
timing of its adds). Their augmentations' draws are made all the same, so
that every later draw stays in step.
"""

from __future__ import annotations

import functools
import random

import numpy as np

from benchmark import synth
from benchmark.reference.codeps_ref.data.preprocessing import (
    ImageWork, augment_data, prepare_for_network, transfer_histogram_style)
from benchmark.reference.readers import MemoryCityscapes

SOURCE_KEYS = (("semantic", np.int32), ("semantic_weights", np.float32),
               ("center", np.float32), ("offset", np.float32),
               ("thing_mask", np.int32))


def frames_of(item, offsets) -> np.ndarray:
    """rgb {0, -1, 1, ...} -> (1, F, H, W, 3) in the order [t, t-1, t+1]."""
    order = [0]
    for offset in offsets:
        order += [-offset, offset]
    stacked = np.stack([np.asarray(item["rgb"][o]) for o in order])
    return (stacked if stacked.dtype == np.uint8
            else stacked.astype(np.float32))[None]


class SourceSampler:
    """Exhaust-before-repeat draws over a source buffer that holds every
    source image."""

    def __init__(self, size: int, count: int, seed: int):
        self.left = np.ones(size, np.int32)
        self.count = count
        self.sampler = np.random.default_rng(seed)

    def draw(self) -> np.ndarray:
        left = self.left
        remaining = int(left.sum())
        if self.count < remaining:
            indices = self.sampler.choice(np.where(left)[0].tolist(),
                                          self.count, replace=False)
            left[indices] = 0
        elif self.count == remaining:
            indices = np.where(left)[0]
            left[:] = 1
        else:
            first = np.where(left)[0]
            left[:] = 1
            second = self.sampler.choice(np.where(left)[0].tolist(),
                                         self.count - len(first),
                                         replace=False)
            left[second] = 0
            indices = np.concatenate([first, second])
        return indices


def side_batches(cfg, seed: int, frames: int, target_stream: int,
                 source_stream: int, source_images: int) -> list:
    """Per frame ``0 .. frames - 1``: ``{"source": {...}, "mixup": {...}}``
    as the runner stacks them, and ``"mixup_from_frame"``: for each mixup
    whether its target is the streamed frame (else a replayed one, whose
    ``rgb_src`` and ``rgb_tgt`` are not worked out)."""
    adapt = cfg.adapt
    offsets = tuple(cfg.dataset.offsets)
    target = synth.SeededFrames(seed, target_stream,
                                cfg.dataset.feed_img_size)
    source = MemoryCityscapes(adapt.source_dataset, "train", source_images,
                              seed, source_stream)
    rng = random.Random(seed)
    sampler_seed = adapt.replay_sampler.seed
    sources = SourceSampler(source_images,
                            adapt.replay_sampler.nof_source_samples,
                            sampler_seed)
    mixup_sampler = np.random.default_rng(sampler_seed)
    cells_rng = np.random.default_rng(sampler_seed)
    target_aug = cfg.dataset.augmentation
    source_aug = source.augmentation_cfg
    n_replay = adapt.replay_sampler.nof_target_samples
    mixup_cfg = adapt.mixup
    cut = mixup_cfg.cut_mix
    out = []
    for k in range(frames):
        work = ImageWork()
        streamed = {"rgb": {0: target.frame(k)}}
        original_target = streamed["rgb"][0]
        prepare_for_network(streamed, cfg.dataset.normalization, work)
        match = functools.partial(transfer_histogram_style,
                                  reference_img=original_target, mode="rgb")
        items = []
        for i in sources.draw():
            item = source.__getitem__(int(i), do_augmentation=False,
                                      do_network_preparation=False)
            original = item["rgb"][0]
            for offset in item["rgb"]:
                work.add(item["rgb"], offset, match)
            augment_data(item, source_aug, rng, work)
            prepare_for_network(item, source.normalization_cfg, work)
            item["rgb_original"] = original
            items.append(item)
        augment_data({"rgb": {}}, target_aug, rng)
        for _ in range(n_replay):
            augment_data({"rgb": {}}, target_aug, rng)
            augment_data({"rgb": {}}, target_aug, rng)
        mixups = []
        if mixup_cfg.general.active:
            strategies = list(mixup_cfg.general.mixup_strategies)
            left_src, left_tgt = [], []
            for counter in range(1, mixup_cfg.general.nof_samples + 1):
                left_src = left_src or list(range(len(items)))
                left_tgt = left_tgt or list(range(n_replay))
                strategy = mixup_sampler.choice(strategies)
                strategies.remove(strategy)
                idx_src = int(mixup_sampler.choice(left_src))
                left_src.remove(idx_src)
                from_frame = counter == 1 or n_replay == 0
                if not from_frame:
                    left_tgt.remove(int(mixup_sampler.choice(left_tgt)))
                rgb_src = {"rgb": {0: items[idx_src]["rgb_original"]}}
                if from_frame:
                    work.add(rgb_src["rgb"], 0, match)
                augment_data(rgb_src, source_aug, rng, work)
                prepare_for_network(rgb_src, source.normalization_cfg, work)
                mixups.append((str(strategy), from_frame, rgb_src,
                               items[idx_src]))
        work.run()
        domain = {"frames": np.concatenate([frames_of(item, offsets)
                                            for item in items]),
                  "camera": np.stack([np.asarray(item["camera_model"],
                                                 np.float32)
                                      for item in items])}
        for key, dtype in SOURCE_KEYS:
            if key in items[0]:
                domain[key] = np.stack([np.asarray(item[key])
                                        for item in items]).astype(dtype)
        fused = [m for name in ("cut_mixup", "class_mixup")
                 for m in mixups if m[0] == name]
        mixup = {}
        if fused:
            nof_splits = cut.nof_vert_splits * cut.nof_hor_splits
            cells = [cells_rng.choice(nof_splits, cut.nof_segments,
                                      replace=False)
                     for name, *_ in fused if name == "cut_mixup"]
            mixup = {"semantic_src": np.stack(
                [np.asarray(item["semantic"]) for *_, item in fused])
                .astype(np.int32),
                "rgb_src": [np.asarray(m[2]["rgb"][0], np.float32)
                            for m in fused],
                "rgb_tgt": [np.asarray(streamed["rgb"][0], np.float32)
                            for _ in fused]}
            if cells:
                mixup["cut_cells"] = np.stack(cells).astype(np.int32)
        out.append({"source": domain, "mixup": mixup,
                    "mixup_from_frame": [m[1] for m in fused]})
    return out


def _gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if got.size else 0.0


def side_gap(batches, redone) -> float:
    """Largest gap between what the port's checked steps took and what the
    buffer's draws give: every source array, the cut cells, every mixup's
    source labels, and its source and target image where its target is the
    streamed frame. Infinite where a part is missing."""
    gap = 0.0
    for batch, want in zip(batches, redone, strict=True):
        got = batch.get("source", {})
        for key, value in want["source"].items():
            if key not in got:
                return float("inf")
            gap = max(gap, _gap(got[key], value))
        mixup, wanted = batch.get("mixup", {}), want["mixup"]
        for key in ("semantic_src", "cut_cells"):
            if key in wanted:
                if key not in mixup:
                    return float("inf")
                gap = max(gap, _gap(mixup[key], wanted[key]))
        for key in ("rgb_src", "rgb_tgt"):
            if wanted and key not in mixup:
                return float("inf")
            for i, from_frame in enumerate(want["mixup_from_frame"]):
                if from_frame:
                    gap = max(gap, _gap(mixup[key][i], wanted[key][i]))
    return gap
