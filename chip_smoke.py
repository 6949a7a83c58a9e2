"""Smoke run of the PyTorch port (``codeps_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

 1. device: needs CUDA; prints the card, the device count and
    ``nvidia-smi``'s name and power limit; TF32 is turned off for
    convolutions and matmuls so comparisons run in full float32;
 2. build: compiles ``codeps_torch/csrc/grouping.cu`` with nvcc (sm_90a);
 3. kernel against plain: ``group_pixels_cuda`` equals
    ``group_pixels_plain`` exactly at 384x1408, K = 200, B = 1 and 2,
    with invalid centers, an image without centers, NaN offsets and
    duplicate centers (truly NHWC offsets, copied once by the wrapper),
    and on the fixed timing inputs of phase 5 at every valid-center count
    (read in place, no copy);
 4. slice: the serving path at full width (ResNet-101, GUDA semantic
    head, instance head, 14 classes, 384x1408, seeded weights) streams
    8 uint8 frames through ``CodepsNet(mode="eval")``; the grouping
    kernel must launch once per frame and read the head's offset planes
    in place (no layout copy), the outputs must be finite and
    well formed, at least one frame must hold a center, and the fused
    maps must equal the fusion recomputed on the CPU with the plain
    grouping; a 64x128 run on the card must agree with the same slice
    on the CPU;
 5. timing: the kernel's device time, its bound and what bounds it on
    fixed inputs that do not depend on the weights (1x384x1408 offsets
    drawn from the seed and passed as the NHWC view of an NCHW tensor,
    K = 200 slots of which the first n are valid, n in VALID_COUNTS);
    then on the inputs of the last streamed frame: the kernel's device
    time, its time per call with the host's launch overhead, and the
    plain version's time per call;
 6. adaptation step: the online adaptation step of
    ``cfg/adapt_cityscapes_kitti_360.yaml`` at full width on the phase-4
    modules (frozen ResNet-101 and instance head; live ResNet-18 pose net,
    depth, pose and semantic heads; semantic teacher EMA 0.99) with the
    published batch: target triplet 1x3x384x1408, 2 target-replay
    triplets, 2 source triplets at 512x1024 with labels, 2 composed
    cut-mixup samples at 512x1024, eval GT. One warm-up step, then 5 timed
    steps; every loss must be finite, frozen parameters bit-unchanged,
    live ones moved, the semantic teacher equal to the EMA formula
    recomputed here, the depth and pose teachers equal to the student, the
    grouping kernel launched once per step with no layout copy, the depth
    metrics finite and the confusion matrix summing to H*W. Prints the
    step latency, steps/s and peak memory. Then one step at 64x192
    (target) and 64x128 (source) from the same weights, batch and
    automask noise on the card and on the CPU, whose losses must agree;
 7. adaptation stream: the port's ``AdaptationRunner`` streams a
    KITTI-360-like target sequence made in memory from the seed (frames,
    semantic/instance GT and sparse depth at 384x1408, STREAM_FRAMES
    frames after the 0.7 adaptation split) with a Cityscapes-like source
    of SOURCE_IMAGES images at 512x1024 through the published config
    (2 source and 2 target replay samples, ``[cut_mixup, cut_mixup]``
    with the camera warp, diversity buffers of 300 at threshold 0.95,
    EMA 0.99 on the semantic head); the readers' code runs on the
    in-memory frames (label decoding, center/offset GT, histogram
    matching, the numpy color jitter), only file decoding is bypassed.
    The grouping kernel must launch twice a frame (teacher eval and GT
    map) with no layout copy and equal its plain version on every call;
    every meter must be finite; every GT panoptic map must hold thing
    segments and score PQ 1 against itself. Frames go to the card as
    float32, the yaml's default. Prints the frame latency (host clock,
    median after 2 warm-up frames, and its range), frames/s (those frames
    over their summed wall time), the host time of
    ``ReplayBuffer.__getitem__`` and of ``buffer.add``, the peak memory
    and the final PQ, mIoU and abs_rel; times the published rare-class
    source sampling on its own. Then the same stream again with frames
    PROFILED_FRAMES after the warm-up traced by ``torch.profiler``: the
    card's busy share of the host's wall time; the stream with uint8
    frames (``normalization.uint8_transfer``), as a second row;
    ``buffer.add`` on its own on an index filled to the buffer's 300
    vectors of 2048 floats, then adds that evict. Last, a 3-frame stream
    at 64x192 (source 64x128) with ResNet-18 runs on the card and on the
    CPU from the same weights, samples and automask noise: their PQ,
    mIoU and abs_rel must agree within ``scripts/parity_e2e.py``'s
    tolerances, their GT panoptic maps must be equal, and so must their
    per-class GT segment counts and true positives;
 8. the ``kernels`` line (with the per-n times and bounds and the layout
    copies on each path), then the last line
    ``{"ok": true, "device": {...}}``.

Random weights from the JAX package's initialization scheme let the
activations grow block by block through ResNet-101 (eval-mode BatchNorm
with unit statistics normalizes nothing), which saturates every head. So
the BatchNorm statistics are first set from one forward pass over a seeded
frame (``calibrate_batch_norm``), as a trained model's would be.

The configuration is the port's adaptation defaults with the values of
``cfg/adapt_cityscapes_kitti_360.yaml`` set in code (feed size 384x1408;
the defaults already give ResNet-101, GUDA fusion, no thing mask,
``codeps`` labels and ImageNet normalization), so no YAML reader is
needed. The center conv's bias is shifted once, before the counted run,
so that the random weights put 0.02% of the pixels over the center
threshold: a few tens of centers, as a street scene has instances.
"""

from __future__ import annotations

import copy
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HEIGHT, WIDTH = 384, 1408
TOP_K = 200
# valid centers of the fixed grouping inputs (phases 3 and 5)
VALID_COUNTS = (0, 16, 64, 200)
NUM_FRAMES = 8
SEED = 0
THINGS = (9, 10, 11, 12, 13)
NUM_CLASSES = 14
# H100 SXM peaks (NVIDIA data sheet): HBM rate and FP32 off the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Card against CPU on one input: cuDNN may run float32 3x3 convolutions
# through Winograd or FFT algorithms, whose rounding error is larger than
# a direct sum's; the 240-channel GUDA conv then moves the semantic
# probabilities by about 1e-4 of their maximum (seen on an H100). The
# adaptation step's losses are means over such outputs and are held to
# the same relative bound.
REL_TOL = 1e-3
# Adaptation step (phase 6): cfg/adapt_cityscapes_kitti_360.yaml.
SOURCE_HEIGHT, SOURCE_WIDTH = 512, 1024
NUM_SOURCE = NUM_REPLAY = NUM_MIXUP = 2
ADAPT_STEPS = 5
# Pinhole intrinsics [fx, fy, cx, cy]: KITTI-360's rectified perspective
# camera 00 at 1408x376 and a Cityscapes camera at 2048x1024, scaled to
# the feed sizes.
KITTI_360_CAMERA = (552.554261, 552.554261 * 384 / 376, 682.049453,
                    238.769549 * 384 / 376)
CITYSCAPES_CAMERA = (2262.52 / 2, 2265.3017905988554 / 2, 1096.98 / 2,
                     513.137 / 2)
# Adaptation stream (phase 7): frames after the 0.7 adaptation split of a
# target sequence of STREAM_FRAMES / 0.7, source images, warm-up frames.
STREAM_FRAMES = 12
SOURCE_IMAGES = 8
WARMUP_FRAMES = 2
# stream frames profiled after the warm-up, for the card's busy share
PROFILED_FRAMES = 3
# full-size images of the two datasets, (W, H)
KITTI_360_FULL = (1408, 376)
CITYSCAPES_FULL = (2048, 1024)
# scripts/parity_e2e.py:52-54, PQ as a fraction
PQ_TOL, MIOU_TOL, ABS_REL_TOL = 0.005, 0.005, 0.005


def phase(name):
    print(f"== {name}", flush=True)


def slice_config():
    from codeps_torch.config import get_cfg_defaults_adapt
    cfg = get_cfg_defaults_adapt()
    # cfg/adapt_cityscapes_kitti_360.yaml, dataset section
    cfg.dataset.name = "kitti_360"
    cfg.dataset.feed_img_size = [HEIGHT, WIDTH]
    cfg.dataset.sequences = ["03"]
    assert cfg.model.po_depth_net.params.nof_layers == 101
    assert cfg.model.semantic_head.use_guda_fusion
    assert not cfg.model.instance_head.use_thing_mask
    assert cfg.dataset.label_mode == "codeps"
    assert cfg.dataset.normalization.active
    return cfg


def grouping_cases(torch, device):
    """(name, centers (B, K, 2), valid (B, K), offsets (B, H, W, 2))."""
    import numpy as np
    rng = np.random.default_rng(SEED)

    def image(valid_share, nan_share=0.0, duplicates=False):
        yx = rng.uniform([0, 0], [HEIGHT, WIDTH], (TOP_K, 2))
        valid = rng.random(TOP_K) < valid_share
        offsets = rng.normal(0, 20, (HEIGHT, WIDTH, 2))
        if nan_share:
            offsets[rng.random((HEIGHT, WIDTH)) < nan_share] = np.nan
        if duplicates:
            yx = np.round(yx)
            yx[1::2] = yx[0::2]
            offsets = np.round(offsets)
        return (yx.astype(np.float32), valid,
                offsets.astype(np.float32))

    cases = [("B=1 random, 70% valid", [image(0.7)]),
             ("B=1 NaN offsets, duplicate centers",
              [image(0.9, nan_share=0.02, duplicates=True)]),
             ("B=2 random + no valid center", [image(0.5), image(0.0)])]
    for name, images in cases:
        yield (name, *(torch.from_numpy(np.stack(parts)).to(device)
                       for parts in zip(*images)))


def fixed_grouping_inputs(torch, device, num_valid):
    """Grouping inputs that do not depend on the model: centers (1, K, 2)
    uniform over the image, of which the first ``num_valid`` are valid
    (the prefix layout of ``find_instance_centers_batch``), and offsets
    ~ N(0, 20) px as the NHWC view (1, H, W, 2) of an NCHW tensor, the
    layout the instance head hands to fusion. The same draws for every
    ``num_valid``."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    planes = rng.normal(0, 20, (1, 2, HEIGHT, WIDTH)).astype(np.float32)
    yx = rng.uniform([0, 0], [HEIGHT, WIDTH], (1, TOP_K, 2))
    valid = np.arange(TOP_K)[None] < num_valid
    return (torch.from_numpy(yx.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device),
            torch.from_numpy(planes).to(device).permute(0, 2, 3, 1))


def grouping_bound(num_valid):
    """(bound_ms, bound_by, bytes, operations) of grouping one
    HEIGHTxWIDTH image against TOP_K slots of which ``num_valid`` are
    valid: offsets read and ids written once (12 bytes a pixel), centers
    and flags read once; 5 FP32 operations per (pixel, valid center)."""
    pixels = HEIGHT * WIDTH
    moved = pixels * (8 + 4) + TOP_K * (8 + 1)
    ops = 5 * pixels * num_valid
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "operations" if ops_ms > bytes_ms else "bytes", moved, ops)


def calibrate_batch_norm(torch, modules, image):
    """Set every BatchNorm's running statistics to those of its input on
    ``image`` (B, H, W, 3 uint8): one forward in train mode with
    cumulative averaging, then back to eval."""
    from codeps_torch.ops.normalize import maybe_normalize
    norms = [m for m in modules.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in norms:
        bn.reset_running_stats()
        bn.momentum = None
    x = maybe_normalize(torch.from_numpy(image).to(
        next(modules.parameters()).device)).permute(0, 3, 1, 2)
    modules.train()
    with torch.no_grad():
        modules.instance_head(modules.backbone_po_depth(x))
    modules.eval()
    for bn in norms:
        bn.momentum = 0.1


def call_ms(torch, fn, iters, warmup):
    """Time per call of ``fn`` with CUDA events around a loop of calls:
    the host's launch overhead included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device time of one call of ``fn`` (a single kernel launch).

    A call of a few microseconds on the card costs more than that on the
    host (Python, checks, the launch itself), so events around a loop of
    calls measure the host. Here a sleep kernel first keeps the card busy
    while the host queues all ``iters`` calls; the events then see only
    the calls' own work.
    """
    host_ms = call_ms(torch, fn, iters, warmup=3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    sleep_ms = 2 * host_ms * iters + 5
    torch.cuda._sleep(int(cycles_per_ms * sleep_ms))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # the host must have queued everything before the sleep ran out
    assert queued_ms < sleep_ms, (queued_ms, sleep_ms)
    return start.elapsed_time(end) / iters


def check_outputs(torch, result, batch, height, width):
    shapes = {"depth": (batch, height, width, 1),
              "semantic_soft": (batch, height, width, NUM_CLASSES),
              "semantic": (batch, height, width),
              "center": (batch, height, width, 1),
              "offset": (batch, height, width, 2),
              "panoptic": (batch, height, width),
              "instance": (batch, height, width)}
    for key, shape in shapes.items():
        value = result[key]
        assert tuple(value.shape) == shape, (key, value.shape)
        if value.is_floating_point():
            assert bool(torch.isfinite(value).all()), f"{key} not finite"
    assert result["semantic"].dtype == torch.int32
    assert result["panoptic"].dtype == result["instance"].dtype == torch.int32
    depth = result["depth"]
    assert bool(((depth >= 0.1 - 1e-4) & (depth <= 100.0 + 1e-3)).all())
    sums = result["semantic_soft"].sum(-1)
    assert bool(torch.allclose(sums, torch.ones_like(sums), atol=1e-4))


def adapt_config(target_size, source_size):
    """The slice config with cfg/adapt_cityscapes_kitti_360.yaml's adapt
    section set in code."""
    cfg = slice_config()
    cfg.dataset.feed_img_size = list(target_size)
    flags = cfg.adapt.model
    flags.backbone_po_depth = False
    flags.backbone_pose_sflow = flags.depth = flags.pose = True
    flags.sflow = False
    flags.semantic = True
    flags.instance = False
    cfg.adapt.ema.alpha = 0.99
    cfg.adapt.ema.semantic = True
    cfg.adapt.ema.instance = False
    cfg.adapt.source_dataset.feed_img_size = list(source_size)
    cfg.adapt.replay_sampler.nof_source_samples = NUM_SOURCE
    cfg.adapt.replay_sampler.nof_target_samples = NUM_REPLAY
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup", "cut_mixup"]
    cfg.adapt.mixup.general.nof_samples = NUM_MIXUP
    cfg.train.nof_adaptation_steps = 1
    return cfg


def adapt_batch(rng, target_size, source_size):
    """One step's batch in the step's layout (uint8 frames, NHWC)."""
    import numpy as np
    (ht, wt), (hs, ws) = target_size, source_size

    def frames(n, h, w):
        return rng.integers(0, 256, (n, 3, h, w, 3), dtype=np.uint8)

    def camera(n, intrinsics):
        return np.tile(np.asarray([intrinsics], np.float32), (n, 1))

    return {
        "target": {"frames": frames(1, ht, wt),
                   "camera": camera(1, KITTI_360_CAMERA)},
        "target_replay": {"frames": frames(NUM_REPLAY, ht, wt),
                          "camera": camera(NUM_REPLAY, KITTI_360_CAMERA)},
        "source": {
            "frames": frames(NUM_SOURCE, hs, ws),
            "camera": camera(NUM_SOURCE, CITYSCAPES_CAMERA),
            "semantic": rng.integers(0, NUM_CLASSES, (NUM_SOURCE, hs, ws),
                                     dtype=np.int32),
            "semantic_weights": rng.uniform(
                1.0, 3.0, (NUM_SOURCE, hs, ws)).astype(np.float32),
            "center": rng.uniform(0, 1, (NUM_SOURCE, hs, ws, 1)).astype(
                np.float32),
            "offset": rng.normal(0, 20, (NUM_SOURCE, hs, ws, 2)).astype(
                np.float32),
        },
        "mixup": {
            "rgb": rng.integers(0, 256, (NUM_MIXUP, hs, ws, 3),
                                dtype=np.uint8),
            "semantic": rng.integers(0, NUM_CLASSES, (NUM_MIXUP, hs, ws),
                                     dtype=np.int32),
        },
        "eval_gt": {
            "semantic": rng.integers(0, NUM_CLASSES, (1, ht, wt),
                                     dtype=np.int32),
            "depth_gt": rng.uniform(1.0, 80.0, (1, ht, wt)).astype(
                np.float32),
        },
    }


def build_adapt(torch, modules, cfg, device):
    """(AdaptState on ``device``, the step) for ``modules``."""
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    from codeps_torch.tasks.adapt_loop import adapt_module_lists
    from codeps_torch.tasks.state import make_adapt_state
    frozen, ema = adapt_module_lists(cfg, modules.module_names())
    state = make_adapt_state(modules, cfg.train.optimizer.learning_rate,
                             ema_modules=ema, frozen_modules=frozen,
                             ema_alpha=cfg.adapt.ema.alpha, seed=SEED,
                             device=device)
    step = make_adapt_step(
        cfg, list(cfg.semantics.class_weights), has_replay=True,
        num_mixup=NUM_MIXUP,
        mixup_groups=(("cut_mixup", NUM_MIXUP),),
        eval_forward=build_eval_forward(cfg, THINGS, NUM_CLASSES))
    return state, step


def automask_noise(torch, rng, target_size, source_size, num_scales):
    """Automask normals for one step in the order the step asks for them
    (source scales, then target scales), as numpy arrays."""
    import numpy as np
    shapes = [(NUM_SOURCE, 2, source_size[0] >> s, source_size[1] >> s)
              for s in range(num_scales)]
    shapes += [(1 + NUM_REPLAY, 2, target_size[0] >> s, target_size[1] >> s)
               for s in range(num_scales)]
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in shapes]


def injected(torch, arrays, device):
    arrays = list(arrays)

    def noise(shape):
        draw = arrays.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(draw).to(device)
    return noise


def check_adapt_outputs(torch, metrics, results, stats, height, width):
    for key, value in metrics.items():
        if key != "target_skipped":
            assert bool(torch.isfinite(value)), f"loss {key} not finite"
    for key in ("d_abs_rel", "d_sq_rel", "d_rmse", "d_rmse_log", "d_a1"):
        assert bool(torch.isfinite(stats[key])), f"{key} not finite"
    conf_sum = int(stats["sem_conf"].sum())
    assert conf_sum == height * width, conf_sum
    check_outputs(torch, results, 1, height, width)


def stream_config(target_size, source_size, layers=101, uint8=False):
    """The adapt config with the rest of cfg/adapt_cityscapes_kitti_360.yaml
    set in code (the replay sampler and buffers, the cut-mixup grid, the
    adaptation split); with ``uint8`` the frames go to the card as uint8
    (``normalization.uint8_transfer``, which the yaml leaves off)."""
    cfg = adapt_config(target_size, source_size)
    cfg.model.po_depth_net.params.nof_layers = layers
    cfg.dataset.path = cfg.adapt.source_dataset.path = "(in memory)"
    cfg.adapt.source_dataset.name = "cityscapes"
    # gen_config copies these dataset settings to the source
    for key in ("center_heatmap_sigma", "return_only_rgb",
                "small_instance_area_full_res", "small_instance_weight",
                "remove_classes", "label_mode", "augmentation",
                "normalization"):
        cfg.adapt.source_dataset[key] = cfg.dataset[key]
    cfg.adapt.target_dataset_adapt_ratio = 0.7
    cfg.adapt.replay_sampler.seed = 42
    cfg.adapt.replay_buffer.seed = 20
    cfg.adapt.replay_buffer.source_size = 300
    cfg.adapt.replay_buffer.target_size = 300
    cfg.adapt.replay_buffer.maximize_diversity = True
    cfg.adapt.replay_buffer.similarity_threshold = 0.95
    cfg.adapt.mixup.general.geom_augment = True
    cfg.adapt.mixup.cut_mix.nof_hor_splits = 4
    cfg.adapt.mixup.cut_mix.nof_vert_splits = 2
    cfg.adapt.mixup.cut_mix.nof_segments = 2
    # a transport setting: the card normalizes with the host's arithmetic,
    # so the model sees the same floats (tests/test_torch_data.py)
    cfg.dataset.normalization.uint8_transfer = uint8
    cfg.adapt.source_dataset.normalization = cfg.dataset.normalization
    return cfg


def scaled_camera(camera, full_size, size):
    """Intrinsics ``camera`` of an image of ``full_size`` (H, W) at
    ``size``."""
    sy, sx = size[0] / full_size[0], size[1] / full_size[1]
    return (camera[0] * sx, camera[1] * sy, camera[2] * sx, camera[3] * sy)


def street_labels(rng, height, width, things):
    """Raw label ids (uint8) and instance ids (uint16) of a street-like
    frame: stuff bands (sky, building, vegetation, sidewalk, road) and
    ``things`` rectangles of people and cars, both classes always
    present."""
    import numpy as np
    semantic = np.empty((height, width), np.uint8)
    for (top, bottom), raw in zip(((0, 0.2), (0.2, 0.45), (0.45, 0.55),
                                   (0.55, 0.7), (0.7, 1.0)),
                                  (23, 11, 21, 8, 7)):
        semantic[int(top * height):int(bottom * height)] = raw
    instance = semantic.astype(np.uint16) * 1000
    for i in range(things):
        raw = (24, 26)[i % 2]
        h = int(rng.integers(height // 10, height // 3))
        w = int(rng.integers(width // 40, width // 8))
        y = int(rng.integers(height // 3, height - h))
        x = int(rng.integers(0, width - w))
        semantic[y:y + h, x:x + w] = raw
        instance[y:y + h, x:x + w] = raw * 1000 + i + 1
    return semantic, instance


def stream_datasets(cfg, frames, source_images, seed):
    """(target, source): the port's KITTI-360 and Cityscapes readers on
    frames made in memory from ``seed`` at the config's feed sizes (their
    ``_read`` replaced; everything after the file decoding is the
    readers' own). The target has ``frames`` / 0.7 frames so that
    ``frames`` remain after the adaptation split; its depth GT is sparse,
    as projected LiDAR is."""
    import numpy as np
    from codeps_torch.data.cityscapes import Cityscapes
    from codeps_torch.data.dataset import Dataset, class_distribution
    from codeps_torch.data.kitti_360 import Kitti360
    rng = np.random.default_rng(seed)

    def sequence(n, height, width):
        images = rng.integers(0, 256, (n + 2, height, width, 3),
                              dtype=np.uint8)
        labels = [street_labels(rng, height, width, 6) for _ in range(n)]
        return images, labels

    class MemoryKitti360(Kitti360):
        def __init__(self):
            Dataset.__init__(self, "kitti_360", ["sequence"], "sequence",
                             cfg.dataset, return_depth=True)
            self.sequence_reference_mode = "rgb"
            self.semantic_seq_mode_image_skipped = []
            self.sequences = list(cfg.dataset.sequences)
            height, width = self.image_size
            n = int(np.ceil(frames / 0.7))
            self.images, self.labels = sequence(n, height, width)
            self.depths = [np.where(rng.random((height, width)) < 0.05,
                                    rng.uniform(2.0, 79.0, (height, width)),
                                    0.0).astype(np.float32)
                           for _ in range(n)]
            self.frame_paths = [{"frame": i} for i in range(n)]
            self.camera_model = np.asarray(scaled_camera(
                KITTI_360_CAMERA, (HEIGHT, WIDTH), self.image_size),
                np.float32)

        def _read(self, index, with_labels):
            n = self.frame_paths[index]["frame"]
            out = {"rgb": {0: self.images[n + 1], -1: self.images[n],
                           1: self.images[n + 2]},
                   "image_size": KITTI_360_FULL}
            if with_labels:
                out["semantic"], out["instance"] = self.labels[n]
                out["depth"] = self.depths[n]
            return out

    class MemoryCityscapes(Cityscapes):
        def __init__(self):
            Dataset.__init__(self, "cityscapes", ["train"], "train",
                             cfg.adapt.source_dataset)
            height, width = self.image_size
            self.images, self.labels = sequence(source_images, height,
                                                width)
            self.frame_paths = [{"frame": i} for i in range(source_images)]
            full = CITYSCAPES_FULL[::-1]
            fx, fy, cx, cy = scaled_camera(CITYSCAPES_CAMERA,
                                           (SOURCE_HEIGHT, SOURCE_WIDTH),
                                           full)
            self.camera = {"intrinsic": {"fx": fx, "fy": fy, "u0": cx,
                                         "v0": cy},
                           "extrinsic": {"baseline": 0.209313}}
            self.distribution = None

        def _read(self, index, with_labels):
            n = self.frame_paths[index]["frame"]
            out = {"rgb": {0: self.images[n + 1], -1: self.images[n],
                           1: self.images[n + 2]},
                   "image_size": CITYSCAPES_FULL, "camera": self.camera}
            if with_labels:
                out["semantic"], out["instance"] = self.labels[n]
            return out

        def load_class_distribution(self):
            # counted here, where the readers load the pickled one
            if self.distribution is None:
                self.distribution = class_distribution(self)
            return self.distribution

    return MemoryKitti360(), MemoryCityscapes()


def build_stream(cfg, modules, device, seed, noise=None):
    """(runner, buffer) of the port on in-memory data: the whole source
    becomes the source buffer."""
    import random
    from codeps_torch.data.replay_buffer import ReplayBuffer
    from codeps_torch.tasks.adapt_loop import AdaptationRunner
    target, source = stream_datasets(cfg, STREAM_FRAMES, SOURCE_IMAGES,
                                     seed)
    buffer = ReplayBuffer(target, cfg.adapt, "train",
                          rng=random.Random(seed))
    buffer.initialize_source_buffer(source, None)
    runner = AdaptationRunner(cfg, modules, buffer, seed=seed, device=device,
                              verbose=False, noise=noise)
    return runner, buffer


def numpy_noise(torch, seed, device):
    """Automask noise from a numpy generator: the same normals, in the same
    order, on every device."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def noise(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)
    return noise


def meter_values(meters):
    """{name: value} of the scalar meters that were updated."""
    import numpy as np
    out = {}
    for kind in ("losses", "metrics"):
        for name, meter in meters[kind].items():
            count = getattr(meter, "count", 1)
            if count and np.ndim(meter.value) == 0:
                out[name] = float(meter.value)
    return out


def drive_stream(torch, runner, card, max_frames=None, on_frame=None):
    """(meters, run) of ``runner``'s stream, with the grouping counts set
    to 0 just before it and read just after. On the ``card`` the kernel
    must launch twice a frame with no layout copy, and every grouping call
    is kept and checked against the plain version after the run.
    ``run`` also holds the (GT, prediction) panoptic maps the PQ meter
    took, the seconds and the peak memory."""
    from codeps_torch.ops import grouping
    from codeps_torch.ops import panoptic as panoptic_ops
    grouped, pq_maps = [], []
    group_pixels = panoptic_ops.group_pixels
    update = runner.panoptic_eval.update

    def recording(yx, valid, offsets):
        out = group_pixels(yx, valid, offsets)
        grouped.append((yx.clone(), valid.clone(), offsets.clone(), out))
        return out

    def recording_update(pan_gt, pan_pred):
        pq_maps.append((pan_gt.copy(), pan_pred.copy()))
        update(pan_gt, pan_pred)

    panoptic_ops.group_pixels = recording
    runner.panoptic_eval.update = recording_update
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0
    t0 = time.perf_counter()
    try:
        meters = runner.run(max_frames=max_frames, on_frame=on_frame)
        if card:
            torch.cuda.synchronize()
    finally:
        panoptic_ops.group_pixels = group_pixels
        runner.panoptic_eval.update = update
    run = {"seconds": time.perf_counter() - t0,
           "launches": grouping.group_pixels_cuda.launches,
           "copies": grouping.group_pixels_cuda.copies,
           "peak": torch.cuda.max_memory_allocated() if card else 0,
           "frames": runner.state.step, "pq_maps": pq_maps,
           "centers": [int(v.sum()) for _, v, _, _ in grouped],
           "max_abs_err": 0}
    if card:
        assert run["launches"] == 2 * run["frames"], run["launches"]
        assert run["copies"] == 0, run["copies"]
        for yx, valid, offsets, out in grouped:
            ref = grouping.group_pixels_plain(yx, valid, offsets)
            run["max_abs_err"] = max(run["max_abs_err"], int(
                (out.long() - ref.long()).abs().max()))
            assert torch.equal(out, ref), "kernel != plain in the stream"
    values = meter_values(meters)
    bad = [k for k, v in values.items() if not math.isfinite(v)]
    assert not bad, f"meters not finite: {bad}"
    return meters, run


def check_gt_maps(pq_maps, stuff, things):
    """Each GT panoptic map the PQ meter took holds thing segments, and
    scores PQ 1 against itself: the accumulation sees what the map
    holds. Returns the thing segments per map."""
    import numpy as np
    from codeps_torch.evaluation.panoptic_metrics import PanopticEvaluator
    segments = []
    for gt, _ in pq_maps:
        ids = set(int(i) for i in np.unique(gt))
        segments.append(sum(1 for i in ids if i // 1000 in things))
        evaluator = PanopticEvaluator(list(stuff), list(things))
        evaluator.update(gt, gt)
        pq = evaluator.evaluate()["All"]["pq"]
        assert pq == 1.0, f"PQ of a GT map against itself: {pq}"
    assert segments and min(segments) > 0, segments
    return segments


def stream_numbers(runner, run):
    """Frame latency (median and range after the warm-up frames), frames/s
    (those frames over their summed wall time) and the host times, ms."""
    latencies = runner.step_times[WARMUP_FRAMES:]
    getitem_ms = [t * 1e3 for t in runner.host_times["getitem"]]
    add_ms = [t * 1e3 for t in runner.host_times["add"]]
    return {
        "frames": run["frames"],
        "frame_ms": statistics.median(latencies) * 1e3,
        "frame_min_ms": min(latencies) * 1e3,
        "frame_max_ms": max(latencies) * 1e3,
        "frames_per_s": len(latencies) / sum(latencies),
        "stream_s": run["seconds"],
        "all_ms": [t * 1e3 for t in runner.step_times],
        "getitem_ms": statistics.median(getitem_ms),
        "getitem_all_ms": getitem_ms,
        "add_ms": statistics.median(add_ms),
        "phases_ms": {name: statistics.median(t[WARMUP_FRAMES:]) * 1e3
                      for name, t in runner.frame_phases.items()},
        "peak_mib": run["peak"] / 2**20}


def print_stream(name, numbers):
    n = numbers
    print(f"{name}: frame latency (host clock, median of "
          f"{n['frames'] - WARMUP_FRAMES} after {WARMUP_FRAMES} warm-up "
          f"frames) {n['frame_ms']:.3f} ms, range {n['frame_min_ms']:.3f}-"
          f"{n['frame_max_ms']:.3f} ms; all: "
          f"{[round(t, 3) for t in n['all_ms']]}")
    print(f"{name}: {n['frames_per_s']:.3f} frames/s (the frames after the "
          f"warm-up over their summed wall time); whole stream "
          f"{n['stream_s']:.3f} s for {n['frames']} frames")
    print(f"{name}: ReplayBuffer.__getitem__ in the worker thread, median "
          f"{n['getitem_ms']:.3f} ms a frame; all "
          f"{[round(t, 3) for t in n['getitem_all_ms']]}")
    print(f"{name}: main thread per frame, median ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in n["phases_ms"].items()))
    print(f"{name}: buffer.add in the stream, median {n['add_ms']:.3f} ms; "
          f"peak device memory {n['peak_mib']:.1f} MiB")


def time_diversity_add(cfg, seed, extra=40):
    """``ReplayBuffer.add`` on its own at the deployment's size: distinct
    seeded features of 2048 floats fill the target buffer to its size
    (300), then ``extra`` more adds each evict one. Returns ms: adds while
    the index holds its last 50 fills, the first evicting add (which builds
    the similarity matrix), the later evicting adds, and a search of the
    full index alone."""
    import random
    import numpy as np
    from codeps_torch.data.replay_buffer import ReplayBuffer
    size = cfg.adapt.replay_buffer.target_size

    class Frames:
        """A target stream long enough to fill the buffer."""
        def __init__(self, n):
            self.frame_paths = [{"frame": i} for i in range(n)]

        def __len__(self):
            return len(self.frame_paths)

    n = int(math.ceil((size + extra) / cfg.adapt.target_dataset_adapt_ratio))
    buffer = ReplayBuffer(Frames(n + 1), cfg.adapt, "train",
                          rng=random.Random(seed))
    features = np.random.default_rng(seed).standard_normal(
        (size + extra, 1, 2048)).astype(np.float32)
    add_ms = []
    for index, feature in enumerate(features):
        t0 = time.perf_counter()
        buffer.add(index, feature)
        add_ms.append((time.perf_counter() - t0) * 1e3)
        assert buffer.sim_index.ntotal == min(index + 1, size), index
    query = features[0] / np.linalg.norm(features[0])
    search_ms = []
    for _ in range(50):
        t0 = time.perf_counter()
        scores, _ = buffer.sim_index.search(query, 1)
        search_ms.append((time.perf_counter() - t0) * 1e3)
    return {"fill_ms": statistics.median(add_ms[size - 50:size]),
            "first_evict_ms": add_ms[size],
            "evict_ms": statistics.median(add_ms[size + 1:]),
            "search_ms": statistics.median(search_ms),
            "size": buffer.sim_index.ntotal,
            "dim": buffer.sim_index.dim}


def device_busy(torch, events):
    """(busy, first start, last end) in us of the card's kernels, copies
    and sets among profiler ``events``; overlaps count once."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        busy += end - start
    return busy, (spans[0][0] if spans else 0.0), (end or 0.0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "machine with a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from codeps_torch.models import CodepsNet, build_modules, init_params
    from codeps_torch.ops import grouping
    from codeps_torch.ops._build import build
    from codeps_torch.ops.panoptic import (find_instance_centers_batch,
                                           panoptic_fusion_batch)

    phase("1 device")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}; count {count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and matmuls: comparisons run "
          "in full float32")

    phase("2 build")
    t0 = time.perf_counter()
    paths = build(["grouping"])
    print(f"built {paths['grouping'].name} in "
          f"{time.perf_counter() - t0:.2f} s")

    phase("3 kernel against plain")
    max_err = 0
    # made one at a time and dropped after, so that none counts in the
    # later phases' peak memory; truly NHWC inputs are copied once, views
    # never
    cases = itertools.chain(
        ((*case, 1) for case in grouping_cases(torch, device)),
        ((f"fixed inputs, first {n} of {TOP_K} valid, NCHW view",
          *fixed_grouping_inputs(torch, device, n), 0)
         for n in VALID_COUNTS))
    for name, yx, valid, offsets, copies in cases:
        before = grouping.group_pixels_cuda.copies
        ours = grouping.group_pixels_cuda(yx, valid, offsets)
        copied = grouping.group_pixels_cuda.copies - before
        ref = grouping.group_pixels_plain(yx, valid, offsets)
        torch.cuda.synchronize()
        err = int((ours.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        print(f"{name}: valid {valid.sum(1).tolist()}, max |id diff| "
              f"{err}, layout copies {copied}")
        assert torch.equal(ours, ref), f"kernel != plain on {name}"
        assert copied == copies, (name, copied)
    del yx, valid, offsets, ours, ref

    phase("4 slice")
    cfg = slice_config()
    import numpy as np
    rng = np.random.default_rng(SEED)
    frames = rng.integers(0, 256, (NUM_FRAMES + 1, 1, HEIGHT, WIDTH, 3),
                          dtype=np.uint8)
    modules = init_params(build_modules(cfg, NUM_CLASSES, device=device),
                          seed=SEED, device=device)
    calibrate_batch_norm(torch, modules, frames[-1])
    net = CodepsNet(modules, thing_list=THINGS, device=device)
    warm = net(frames[-1], mode="eval")
    shift = float(0.1 - torch.quantile(warm["center"].flatten(), 0.9998))
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.add_(shift)
    net(frames[-1], mode="eval")
    torch.cuda.synchronize()
    print(f"center bias shifted by {shift:.4f}")

    torch.cuda.reset_peak_memory_stats()
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0
    results, seconds = [], []
    for frame in frames[:NUM_FRAMES]:
        t0 = time.perf_counter()
        results.append(net(frame, mode="eval"))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = grouping.group_pixels_cuda.launches
    copies = grouping.group_pixels_cuda.copies
    peak = torch.cuda.max_memory_allocated()
    print(f"grouping launches in the streamed run: {launches}; layout "
          f"copies: {copies}")
    assert launches == NUM_FRAMES, launches
    assert copies == 0, copies

    centers_per_frame = []
    for result in results:
        check_outputs(torch, result, 1, HEIGHT, WIDTH)
        cpu = {k: v.cpu() for k, v in result.items() if v is not None}
        pan, inst, centers = panoptic_fusion_batch(
            cpu["semantic_soft"], cpu["center"], cpu["offset"], THINGS)
        assert torch.equal(inst, cpu["instance"]), "instance != plain"
        assert torch.equal(pan, cpu["panoptic"]), "panoptic != plain"
        centers_per_frame.append(int(centers.valid.sum()))
    print(f"valid centers per frame: {centers_per_frame}")
    assert max(centers_per_frame) > 0, "no frame had a center"
    latency_ms = statistics.median(seconds) * 1e3
    print(f"per-frame latency (host clock, median of {NUM_FRAMES}): "
          f"{latency_ms:.3f} ms; all: "
          f"{[round(s * 1e3, 3) for s in seconds]}")
    print(f"peak device memory: {peak / 2**20:.1f} MiB")

    small = [64, 128]
    small_cfg = slice_config()
    small_cfg.dataset.feed_img_size = small
    small_frames = rng.integers(0, 256, (2, 1, *small, 3), dtype=np.uint8)
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules, small_frames[0])
    with torch.no_grad():
        cpu_modules.instance_head.center_head.net.conv.bias.add_(shift)
    card_modules = copy.deepcopy(cpu_modules)
    on_card, on_cpu = (
        CodepsNet(mods, thing_list=THINGS, device=dev)(small_frames[1],
                                                       mode="eval")
        for mods, dev in ((card_modules, device), (cpu_modules, "cpu")))
    check_outputs(torch, on_card, 1, *small)
    for key in ("depth", "semantic_soft", "center", "offset"):
        ref = on_cpu[key]
        err = float((on_card[key].cpu() - ref).abs().max())
        bound = REL_TOL * float(ref.abs().max())
        print(f"64x128 card vs CPU {key}: max abs err {err:.3g} "
              f"(bound {bound:.3g})")
        assert err <= bound, key
    for key in ("semantic", "panoptic", "instance"):
        agree = float((on_card[key].cpu() == on_cpu[key]).float().mean())
        print(f"64x128 card vs CPU {key}: {agree:.6f} of pixels agree")
        # near-ties of the float outputs may flip a few pixels
        assert agree >= 0.999, key

    phase("5 timing")
    by_valid = []
    for n in VALID_COUNTS:
        yx, valid, offsets = fixed_grouping_inputs(torch, device, n)
        n_ms = device_ms(torch, lambda: grouping.group_pixels_cuda(
            yx, valid, offsets), iters=100)
        n_bound_ms, n_bound_by, moved, ops = grouping_bound(n)
        by_valid.append({"valid_centers": n, "ms": n_ms,
                         "bound_ms": n_bound_ms, "bound_by": n_bound_by})
        print(f"group_pixels, fixed inputs 1x{HEIGHT}x{WIDTH}, {n} valid "
              f"of {TOP_K}: kernel device time {n_ms * 1e3:.3f} us; bound "
              f"{n_bound_ms * 1e3:.3f} us ({n_bound_by}: {moved} B, {ops} "
              f"FP32 ops)")

    last = results[-1]
    centers = find_instance_centers_batch(last["center"][..., 0],
                                          top_k=TOP_K)
    yx, valid, offsets = centers.yx, centers.valid, last["offset"]

    def kernel():
        return grouping.group_pixels_cuda(yx, valid, offsets)

    def plain():
        return grouping.group_pixels_plain(yx, valid, offsets)

    kernel_ms = device_ms(torch, kernel, iters=100)
    kernel_call_ms = call_ms(torch, kernel, iters=100, warmup=10)
    # The plain version is some 1,600 small launches per call, more than
    # the launch queue holds, so only its time per call is measured.
    plain_ms = call_ms(torch, plain, iters=10, warmup=3)
    num_valid = int(valid.sum())
    bound_ms, bound_by, moved, ops = grouping_bound(num_valid)
    print(f"group_pixels, last streamed frame 1x{HEIGHT}x{WIDTH}, "
          f"{num_valid} valid of {TOP_K}: kernel device time "
          f"{kernel_ms * 1e3:.3f} us, per call with the host "
          f"{kernel_call_ms * 1e3:.3f} us; plain per call "
          f"{plain_ms * 1e3:.3f} us; bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}: {moved} B, {ops} FP32 ops)")
    timing_copies = grouping.group_pixels_cuda.copies - copies
    print(f"layout copies in the timing runs: {timing_copies}")
    assert timing_copies == 0, timing_copies

    phase("6 adaptation step")
    target_size, source_size = (HEIGHT, WIDTH), (SOURCE_HEIGHT,
                                                 SOURCE_WIDTH)
    cfg = adapt_config(target_size, source_size)
    state, step = build_adapt(torch, modules, cfg, device)
    frozen = {name: [p.detach().clone() for p in
                     getattr(state.student, name).parameters()]
              for name in state.frozen_modules}
    live0 = {name: [p.detach().clone() for p in
                    getattr(state.student, name).parameters()]
             for name in state.live_modules()}
    print(f"frozen: {list(state.frozen_modules)}; live: "
          f"{state.live_modules()}; EMA: {list(state.ema_modules)}")
    from codeps_torch.tasks.adapt import batch_to_device
    batch = batch_to_device(adapt_batch(rng, target_size, source_size),
                            device)
    step(state, batch)                                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grouping.group_pixels_cuda.launches = 0
    grouping.group_pixels_cuda.copies = 0
    step_seconds = []
    for i in range(ADAPT_STEPS):
        if i == ADAPT_STEPS - 1:
            ema0 = [p.detach().clone() for p in
                    state.teacher.semantic_head.parameters()]
        t0 = time.perf_counter()
        metrics, features, results, stats = step(state, batch)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        check_adapt_outputs(torch, metrics, results, stats, HEIGHT, WIDTH)
    adapt_launches = grouping.group_pixels_cuda.launches
    adapt_copies = grouping.group_pixels_cuda.copies
    adapt_peak = torch.cuda.max_memory_allocated()
    print(f"grouping launches in the {ADAPT_STEPS} timed steps: "
          f"{adapt_launches}; layout copies: {adapt_copies}")
    assert adapt_launches == ADAPT_STEPS, adapt_launches
    assert adapt_copies == 0, adapt_copies
    print("losses of the last step: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in metrics.items()))
    print(f"teacher eval of the last step: d_abs_rel "
          f"{float(stats['d_abs_rel']):.6g}, confusion matrix sum "
          f"{int(stats['sem_conf'].sum())}, "
          f"{int(results['instance'].max())} instance ids")
    assert tuple(features.shape) == (1, 2048), features.shape
    assert int(state.dist_count) == 1 + ADAPT_STEPS, int(state.dist_count)
    for name, before in frozen.items():
        for p, p0 in zip(getattr(state.student, name).parameters(), before):
            assert torch.equal(p, p0), f"frozen {name} moved"
    for name, before in live0.items():
        moved = any(not torch.equal(p, p0) for p, p0 in zip(
            getattr(state.student, name).parameters(), before))
        assert moved, f"live {name} did not move"
    alpha = state.ema_alpha["semantic_head"]
    for e, e0, p in zip(state.teacher.semantic_head.parameters(), ema0,
                        state.student.semantic_head.parameters()):
        assert torch.equal(e, alpha * e0 + (1.0 - alpha) * p), \
            "semantic teacher != EMA formula"
    for name in ("depth_head", "pose_head", "backbone_pose_sflow"):
        for e, p in zip(getattr(state.teacher, name).parameters(),
                        getattr(state.student, name).parameters()):
            assert torch.equal(e, p), f"{name} teacher != student"
    step_ms = statistics.median(step_seconds) * 1e3
    print(f"adaptation step latency (host clock, median of "
          f"{ADAPT_STEPS}): {step_ms:.3f} ms; all: "
          f"{[round(t * 1e3, 3) for t in step_seconds]}")
    print(f"adaptation steps per second: {1e3 / step_ms:.3f}")
    print(f"adaptation peak device memory: {adapt_peak / 2**20:.1f} MiB")
    del state, batch, metrics, results, stats, features, frozen, live0

    small_target, small_source = (64, 192), (64, 128)
    small_cfg = adapt_config(small_target, small_source)
    small_batch = adapt_batch(rng, small_target, small_source)
    noise = automask_noise(torch, rng, small_target, small_source,
                           small_cfg.depth.num_recon_scales)
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules,
                         small_batch["target"]["frames"][:, 0])
    card_modules = copy.deepcopy(cpu_modules)
    outs = {}
    for name, mods, dev in (("card", card_modules, device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        small_state, small_step = build_adapt(torch, mods, small_cfg, dev)
        metrics, features, results, stats = small_step(
            small_state, small_batch, noise=injected(torch, noise, dev))
        outs[name] = ({k: float(v) for k, v in metrics.items()},
                      features.cpu(), {k: float(v) for k, v in stats.items()
                                       if v.ndim == 0})
    for key, ref in outs["cpu"][0].items():
        err = abs(outs["card"][0][key] - ref)
        print(f"64x192 step card vs CPU {key}: {outs['card'][0][key]:.6g} "
              f"vs {ref:.6g}, rel err {err / max(abs(ref), 1e-30):.3g}")
        assert err <= REL_TOL * abs(ref), key
    err = float((outs["card"][1] - outs["cpu"][1]).abs().max())
    print(f"64x192 step card vs CPU replay features: max abs err {err:.3g}")
    assert err <= REL_TOL * float(outs["cpu"][1].abs().max())
    for key in ("d_abs_rel", "d_rmse"):
        ref = outs["cpu"][2][key]
        assert abs(outs["card"][2][key] - ref) <= REL_TOL * abs(ref), key

    phase("7 adaptation stream")
    from codeps_torch.data.dataset import class_distribution
    from codeps_torch.data.replay_buffer import rare_class_sample
    from torch.profiler import ProfilerActivity, profile, schedule
    cfg = stream_config(target_size, source_size)
    # the streams' peak memory counts what a stream holds: the earlier
    # phases' outputs go, and the weights every stream starts from wait
    # on the host
    del net, warm, last, centers, yx, valid, offsets, card_modules, on_card
    stream_modules = modules.cpu()
    runner, buffer = build_stream(cfg, copy.deepcopy(stream_modules).to(
        device), device, SEED)
    frames = len(buffer)
    print(f"stream, published config (float32 frames): {frames} frames of "
          f"{HEIGHT}x{WIDTH} after the adaptation split, source "
          f"{len(buffer.source_data)} images of {SOURCE_HEIGHT}x"
          f"{SOURCE_WIDTH}; frozen {list(runner.state.frozen_modules)}, EMA "
          f"{list(runner.state.ema_modules)}")
    meters, run = drive_stream(torch, runner, card=True)
    stream_launches, stream_copies = run["launches"], run["copies"]
    stream_err = run["max_abs_err"]
    print(f"grouping launches in the stream: {stream_launches} in {frames} "
          f"frames; layout copies: {stream_copies}")
    assert run["frames"] == frames, run["frames"]
    print(f"kernel == plain on all {len(run['centers'])} grouping calls of "
          f"the stream; valid centers per call: {run['centers']}")
    segments = check_gt_maps(run["pq_maps"], runner.stuff_list,
                             runner.thing_list)
    print(f"GT panoptic maps: thing segments per frame {segments}; each "
          f"scores PQ 1 against itself")
    values = meter_values(meters)
    published = stream_numbers(runner, run)
    print_stream("published", published)
    print(f"buffer holds {buffer.sim_index.ntotal} of {frames} frames")
    print("final meters: " + ", ".join(
        f"{k} {values[k]:.6g}" for k in ("p_pq", "p_sq", "p_rq", "sem_miou",
                                         "sem_miou_pixels", "d_abs_rel",
                                         "d_a1")))
    print("mean losses: " + ", ".join(
        f"{k} {v:.6g}" for k, v in values.items()
        if k in meters["losses"]))
    # host data preparation on its own, nothing else running
    alone_ms = []
    for index in range(3):
        t0 = time.perf_counter()
        buffer[index]
        alone_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"ReplayBuffer.__getitem__ on its own: "
          f"{[round(t, 3) for t in alone_ms]} ms")
    source = buffer.source_data
    t0 = time.perf_counter()
    distribution = class_distribution(source)
    count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    drawn = rare_class_sample(distribution, SOURCE_IMAGES // 2,
                              cfg.adapt.replay_buffer.seed)
    draw_s = time.perf_counter() - t0
    print(f"rare-class source sampling: class distribution of "
          f"{len(source)} images {count_s * 1e3:.3f} ms, {len(drawn)} images "
          f"drawn {draw_s * 1e3:.3f} ms: {sorted(int(i) for i in drawn)}")
    del runner, buffer, meters, run, source

    # the card's busy share of stream frames after the warm-up: the same
    # stream again, with frames first..last profiled (CUDA activity only)
    first = WARMUP_FRAMES + 1
    last = first + PROFILED_FRAMES - 1
    runner, _ = build_stream(cfg, copy.deepcopy(stream_modules).to(device),
                             device, SEED)
    marks, traced = {}, {}

    def trace_ready(prof):
        traced["busy"] = device_busy(torch, prof.events())

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=first - 1, warmup=1,
                                   active=PROFILED_FRAMES, repeat=1),
                 on_trace_ready=trace_ready) as prof:
        def on_frame(it):
            marks[it] = time.perf_counter()
            prof.step()
        drive_stream(torch, runner, card=True, max_frames=last + 1,
                     on_frame=on_frame)
    busy_us, start_us, end_us = traced["busy"]
    assert busy_us > 0, "no device work in the profiled frames"
    window_ms = (marks[last] - marks[first - 1]) * 1e3
    busy = {"frames": [first, last],
            "host_ms": window_ms / PROFILED_FRAMES,
            "device_busy_ms": busy_us / 1e3 / PROFILED_FRAMES,
            "busy_share": busy_us / 1e3 / window_ms,
            "device_span_ms": (end_us - start_us) / 1e3 / PROFILED_FRAMES,
            "step_ms": statistics.median(
                runner.frame_phases["step"][first:last + 1]) * 1e3}
    print(f"profiled frames {first}-{last}: host {busy['host_ms']:.3f} ms "
          f"a frame (profiler on), of which the main thread's step "
          f"{busy['step_ms']:.3f} ms (median); card busy "
          f"{busy['device_busy_ms']:.3f} ms a frame = "
          f"{100 * busy['busy_share']:.1f}% of the host's window, idle "
          f"{100 * (1 - busy['busy_share']):.1f}%; first to last device "
          f"work {busy['device_span_ms']:.3f} ms a frame")
    del runner

    # the uint8 transport (an option of the config; the card normalizes)
    runner, _ = build_stream(stream_config(target_size, source_size,
                                           uint8=True),
                             copy.deepcopy(stream_modules).to(device), device,
                             SEED)
    meters, run = drive_stream(torch, runner, card=True)
    assert run["frames"] == frames, run["frames"]
    check_gt_maps(run["pq_maps"], runner.stuff_list, runner.thing_list)
    print(f"uint8 frames: grouping launches {run['launches']} in {frames} "
          f"frames, layout copies {run['copies']}, kernel == plain on every "
          f"call")
    uint8_frames = stream_numbers(runner, run)
    print_stream("uint8 frames", uint8_frames)
    del runner, meters, run, stream_modules, modules

    # the diversity buffer at the size a deployment reaches
    diversity = time_diversity_add(cfg, SEED)
    print(f"buffer.add on its own, index of {diversity['size']} vectors of "
          f"{diversity['dim']} floats: {diversity['fill_ms']:.3f} ms (median "
          f"of the last 50 adds that fill it), first evicting add "
          f"{diversity['first_evict_ms']:.3f} ms (builds the similarity "
          f"matrix), later evicting adds {diversity['evict_ms']:.3f} ms "
          f"(median); a search of the full index alone "
          f"{diversity['search_ms']:.3f} ms")

    small_target, small_source = (64, 192), (64, 128)
    small_cfg = stream_config(small_target, small_source, layers=18)
    cpu_modules = init_params(build_modules(
        small_cfg, NUM_CLASSES, device="cpu"), seed=SEED, device="cpu")
    calibrate_batch_norm(torch, cpu_modules, rng.integers(
        0, 256, (1, *small_target, 3), dtype=np.uint8))
    card_modules = copy.deepcopy(cpu_modules)
    small = {}
    for name, mods, dev in (("card", card_modules, device),
                            ("cpu", cpu_modules, torch.device("cpu"))):
        small_runner, _ = build_stream(small_cfg, mods, dev, SEED,
                                       noise=numpy_noise(torch, SEED, dev))
        small_meters, small_run = drive_stream(
            torch, small_runner, card=name == "card", max_frames=3)
        labels = (small_runner.stuff_list, small_runner.thing_list)
        assert small_run["frames"] == 3
        stats = small_runner.panoptic_eval.pq_stats.pq_per_cat
        small[name] = (meter_values(small_meters), small_run["pq_maps"],
                       {int(c): (s.tp, s.fp, s.fn, s.iou)
                        for c, s in sorted(stats.items())})
    for key, tol in (("p_pq", PQ_TOL), ("sem_miou", MIOU_TOL),
                     ("d_abs_rel", ABS_REL_TOL)):
        card, cpu = small["card"][0][key], small["cpu"][0][key]
        print(f"64x192 stream card vs CPU {key}: {card:.6g} vs {cpu:.6g}, "
              f"|diff| {abs(card - cpu):.3g} (bound {tol})")
        assert abs(card - cpu) <= tol, key
    for key in small["cpu"][0]:
        assert key in small["card"][0], key
    # PQ is 0 with random heads: the GT maps and the per-class counts are
    # what can disagree
    assert len(small["card"][1]) == len(small["cpu"][1]) == 3
    for (gt_card, pred_card), (gt_cpu, pred_cpu) in zip(small["card"][1],
                                                        small["cpu"][1]):
        assert np.array_equal(gt_card, gt_cpu), "GT panoptic map card != CPU"
        print(f"64x192 stream GT panoptic map: card == CPU, "
              f"{len(np.unique(gt_card))} segments; the predicted maps agree "
              f"on {float((pred_card == pred_cpu).mean()):.6f} of the pixels")
    check_gt_maps(small["card"][1], *labels)
    print(f"64x192 stream PQ statistics per class (tp, fp, fn, iou): card "
          f"{small['card'][2]}; CPU {small['cpu'][2]}")
    gt_segments = {name: {c: tp + fn for c, (tp, _, fn, _) in
                          side[2].items() if tp + fn}
                   for name, side in small.items()}
    assert gt_segments["card"] == gt_segments["cpu"], gt_segments
    assert sum(gt_segments["card"].values()) > 0, gt_segments
    for c, (tp, _, fn, _) in small["cpu"][2].items():
        assert small["card"][2].get(c, (0, 0, 0, 0))[0] == tp, c

    phase("8 result")
    print(json.dumps({"kernels": [{
        "name": "group_pixels", "route": "cuda",
        "source": "codeps_torch/csrc/grouping.cu",
        "replaces": "codeps_tpu/ops/pallas/grouping.py:30",
        "launches": launches + adapt_launches + stream_launches,
        "launches_by_path": {"serve": launches, "adapt": adapt_launches,
                             "stream": stream_launches},
        "copies_by_path": {"serve": copies, "adapt": adapt_copies,
                           "stream": stream_copies},
        "exact": True, "max_abs_err": max(max_err, stream_err),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "kernel_ms": kernel_ms, "bound_us": bound_ms * 1e3,
        "call_ms": kernel_call_ms,
        "valid_centers": num_valid, "by_valid_centers": by_valid}]}))
    print(json.dumps({"adapt_step": {
        "ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "peak_mib": adapt_peak / 2**20,
        "all_ms": [t * 1e3 for t in step_seconds]}}))
    keep = ("frames", "frame_ms", "frame_min_ms", "frame_max_ms",
            "frames_per_s", "getitem_ms", "add_ms", "peak_mib")
    print(json.dumps({"adapt_stream": {
        "published": {k: published[k] for k in keep},
        "uint8_frames": {k: uint8_frames[k] for k in keep},
        "device_busy": busy, "diversity_add": diversity,
        "p_pq": values["p_pq"], "sem_miou": values["sem_miou"],
        "d_abs_rel": values["d_abs_rel"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
