"""Seeded traffic: street-like frames, labels and sparse depth made per
index from the run's seed, never stored, so a sequence can be as long as
any window needs.

Frames are seeded noise (no dataset is in the repo). Each reader keeps a
small pool of noise images per size, made on first use in the process that
reads (a loader worker too); frame ``k`` is pool image ``k % POOL`` rolled
by a seeded number of columns, so neighbouring frames differ and making
one costs a copy. Labels are ``street_labels`` bands and rectangles, depth
5% of the pixels at 2-79 m, as projected LiDAR is.

Copied from ``chip_smoke.py`` (``street_labels``, ``memory_depths``,
``scaled_camera`` and the camera constants), so that later changes to that
script leave the yardstick as it is.
"""

from __future__ import annotations

import numpy as np

POOL = 8
# Pinhole intrinsics [fx, fy, cx, cy]: KITTI-360's rectified perspective
# camera 00 (at 1408x376, given here at 384x1408) and a Cityscapes camera
# at 1024x2048 given at 512x1024.
KITTI_360_CAMERA = (552.554261, 552.554261 * 384 / 376, 682.049453,
                    238.769549 * 384 / 376)
KITTI_360_CAMERA_SIZE = (384, 1408)
CITYSCAPES_CAMERA = (2262.52 / 2, 2265.3017905988554 / 2, 1096.98 / 2,
                     513.137 / 2)
CITYSCAPES_CAMERA_SIZE = (512, 1024)
# full-size images of the two datasets, (W, H)
KITTI_360_FULL = (1408, 376)
CITYSCAPES_FULL = (2048, 1024)
CITYSCAPES_BASELINE = 0.209313


def scaled_camera(camera, full_size, size):
    """Intrinsics ``camera`` of an image of ``full_size`` (H, W) at
    ``size``."""
    sy, sx = size[0] / full_size[0], size[1] / full_size[1]
    return (camera[0] * sx, camera[1] * sy, camera[2] * sx, camera[3] * sy)


def street_labels(rng, height, width, things, stuff=(23, 11, 21, 8, 7),
                  thing_ids=(24, 26), stuff_instances=True):
    """Raw label ids (uint8) and instance ids (uint16) of a street-like
    frame: five bands of ``stuff`` ids (KITTI-360's and Cityscapes' sky,
    building, vegetation, sidewalk, road) and ``things`` rectangles
    alternating between the two ``thing_ids`` (people and cars). A thing's
    instance id is its raw id * 1000 + its number; stuff pixels carry raw
    id * 1000, or 0 without ``stuff_instances``."""
    semantic = np.empty((height, width), np.uint8)
    for (top, bottom), raw in zip(((0, 0.2), (0.2, 0.45), (0.45, 0.55),
                                   (0.55, 0.7), (0.7, 1.0)), stuff):
        semantic[int(top * height):int(bottom * height)] = raw
    instance = semantic.astype(np.uint16) * 1000 if stuff_instances \
        else np.zeros((height, width), np.uint16)
    for i in range(things):
        raw = thing_ids[i % 2]
        h = int(rng.integers(height // 10, height // 3))
        w = int(rng.integers(width // 40, width // 8))
        y = int(rng.integers(height // 3, height - h))
        x = int(rng.integers(0, width - w))
        semantic[y:y + h, x:x + w] = raw
        instance[y:y + h, x:x + w] = raw * 1000 + i + 1
    return semantic, instance


class SeededFrames:
    """Frames, labels and depth of one sequence at ``size`` (H, W), each a
    function of (``seed``, ``stream``, index). Pickles without its pool,
    which each process makes again from the seed."""

    def __init__(self, seed: int, stream: int, size, things: int = 6):
        self.seed, self.stream = int(seed), int(stream)
        self.size = tuple(int(s) for s in size)
        self.things = things
        self._pool = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_pool"] = None
        return state

    def _rng(self, *key):
        return np.random.default_rng([self.seed, self.stream, *key])

    def pool(self) -> np.ndarray:
        if self._pool is None:
            height, width = self.size
            self._pool = self._rng(0).integers(
                0, 256, (POOL, height, width, 3), dtype=np.uint8)
        return self._pool

    def frame(self, k: int) -> np.ndarray:
        """uint8 (H, W, 3) frame ``k`` (any integer, also negative)."""
        shift = int(self._rng(1, k % (1 << 62)).integers(0, self.size[1]))
        return np.roll(self.pool()[k % POOL], shift, axis=1)

    def triplet(self, k: int):
        """{0: frame k, -1: frame k - 1, 1: frame k + 1}."""
        return {0: self.frame(k), -1: self.frame(k - 1),
                1: self.frame(k + 1)}

    def labels(self, k: int, **labels):
        return street_labels(self._rng(2, k), *self.size, self.things,
                             **labels)

    def depth(self, k: int) -> np.ndarray:
        rng = self._rng(3, k)
        height, width = self.size
        return np.where(rng.random((height, width)) < 0.05,
                        rng.uniform(2.0, 79.0, (height, width)),
                        0.0).astype(np.float32)


def feature_rows(seed: int, count: int, dim: int) -> np.ndarray:
    """``count`` non-negative rows of ``dim`` floats (pooled ReLU features
    of frames a drive saw before the window), seeded."""
    rng = np.random.default_rng([int(seed), 9])
    return np.abs(rng.standard_normal((count, dim))).astype(np.float32)


# ---- the readers' in-memory ``_read``: shared by the port's readers
# (``benchmark/readers.py``) and the frozen copy's
# (``benchmark/reference/readers.py``); everything after the file decoding
# is the readers' own code.

def cityscapes_init(reader, dataset_init, cfg_dataset, mode, count, seed,
                    stream):
    dataset_init(reader, "cityscapes", [mode], mode, cfg_dataset)
    reader.frames = SeededFrames(seed, stream, reader.image_size)
    reader.frame_paths = [{"frame": i} for i in range(count)]
    fx, fy, cx, cy = scaled_camera(CITYSCAPES_CAMERA,
                                   CITYSCAPES_CAMERA_SIZE,
                                   CITYSCAPES_FULL[::-1])
    reader.camera = {"intrinsic": {"fx": fx, "fy": fy, "u0": cx, "v0": cy},
                     "extrinsic": {"baseline": CITYSCAPES_BASELINE}}


def cityscapes_read(reader, index, with_labels):
    n = reader.frame_paths[index]["frame"]
    out = {"rgb": reader.frames.triplet(n), "image_size": CITYSCAPES_FULL,
           "camera": reader.camera}
    if with_labels:
        out["semantic"], out["instance"] = reader.frames.labels(n)
    return out


def kitti360_init(reader, dataset_init, cfg_dataset, count, seed, stream):
    dataset_init(reader, "kitti_360", ["sequence"], "sequence", cfg_dataset,
                 return_depth=True)
    reader.sequence_reference_mode = "rgb"
    reader.semantic_seq_mode_image_skipped = []
    reader.sequences = list(cfg_dataset.sequences)
    reader.frames = SeededFrames(seed, stream, reader.image_size)
    reader.frame_paths = [{"frame": i} for i in range(count)]
    reader.camera_model = np.asarray(scaled_camera(
        KITTI_360_CAMERA, KITTI_360_CAMERA_SIZE, reader.image_size),
        np.float32)


def kitti360_read(reader, index, with_labels):
    n = reader.frame_paths[index]["frame"]
    out = {"rgb": reader.frames.triplet(n), "image_size": KITTI_360_FULL}
    if with_labels:
        out["semantic"], out["instance"] = reader.frames.labels(n)
        out["depth"] = reader.frames.depth(n)
    return out
