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
 7. the ``kernels`` line (with the per-n times and bounds and the layout
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


def adapt_modules(cfg):
    """(frozen, EMA-filtered) module names from the adapt flags, as
    scripts/adapt.py:124-145 derives them."""
    flags = cfg.adapt.model
    frozen = [name for name, live in (
        ("backbone_po_depth", flags.backbone_po_depth),
        ("backbone_pose_sflow", flags.backbone_pose_sflow),
        ("depth_head", flags.depth), ("pose_head", flags.pose),
        ("semantic_head", flags.semantic),
        ("instance_head", flags.instance)) if not live]
    ema = ["semantic_head"] if cfg.adapt.ema.semantic else []
    return tuple(frozen), tuple(ema)


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
    from codeps_torch.tasks.state import make_adapt_state
    frozen, ema = adapt_modules(cfg)
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

    phase("7 result")
    print(json.dumps({"kernels": [{
        "name": "group_pixels", "route": "cuda",
        "source": "codeps_torch/csrc/grouping.cu",
        "replaces": "codeps_tpu/ops/pallas/grouping.py:30",
        "launches": launches + adapt_launches,
        "launches_by_path": {"serve": launches, "adapt": adapt_launches},
        "copies_by_path": {"serve": copies, "adapt": adapt_copies},
        "exact": True, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "kernel_ms": kernel_ms, "bound_us": bound_ms * 1e3,
        "call_ms": kernel_call_ms,
        "valid_centers": num_valid, "by_valid_centers": by_valid}]}))
    print(json.dumps({"adapt_step": {
        "ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "peak_mib": adapt_peak / 2**20,
        "all_ms": [t * 1e3 for t in step_seconds]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
