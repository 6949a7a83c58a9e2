"""Where the port's adaptation step spends the card's time.

    python3 profile_adapt_step.py [--steps N]

Sets up the step as ``chip_smoke.py`` phase 6 does (full width: frozen
ResNet-101 with calibrated BatchNorm, live ResNet-18 pose net and depth,
pose and semantic heads, the published batch of
``cfg/adapt_cityscapes_kitti_360.yaml``, float32 with TF32 off), runs one
warm-up step, then N steps (default 3) under ``torch.profiler``. Prints:

  - the step latency with the profiler on (host clock, synchronized);
  - the device busy share: the union of the kernels' intervals over the
    profiled window, and the idle rest;
  - device time per step by kernel class (convolutions forward and
    backward, BatchNorm, elementwise, reductions, grid sampling, sort and
    top-k, resize, copies, the grouping kernel) and the 40 kernels that
    take the most.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

CLASSES = (
    # (class, kernel-name pattern), first match wins
    ("grouping kernel", r"group_pixels"),
    ("batch norm", r"batch_norm|bn_fw|bn_bw"),
    ("conv weight grad", r"wgrad|conv2d_grad_weight|"
                         r"convolution_backward_weight"),
    ("conv data grad", r"dgrad|conv2d_grad_input"),
    ("conv / gemm", r"conv|xmma|implicit|winograd|cutlass|gemm|sm90|"
                    r"cudnn|fft"),
    ("grid sample", r"grid_sampler"),
    ("sort / top-k", r"sort|topk|radix|select"),
    ("resize / pool", r"upsample|interp|pool"),
    ("reduction", r"reduce"),
    ("copy / cat / pad", r"copy|cat|pad|index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled|foreach"),
)


def classify(name: str) -> str:
    lower = name.lower()
    for label, pattern in CLASSES:
        if re.search(pattern, lower):
            return label
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_adapt_step: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import numpy as np
    import chip_smoke as smoke
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks.adapt import batch_to_device
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}")
    target, source = ((smoke.HEIGHT, smoke.WIDTH),
                      (smoke.SOURCE_HEIGHT, smoke.SOURCE_WIDTH))
    cfg = smoke.adapt_config(target, source)
    rng = np.random.default_rng(smoke.SEED)
    modules = init_params(build_modules(cfg, smoke.NUM_CLASSES,
                                        device=device),
                          seed=smoke.SEED, device=device)
    smoke.calibrate_batch_norm(
        torch, modules, rng.integers(0, 256, (1, *target, 3), np.uint8))
    state, step = smoke.build_adapt(torch, modules, cfg, device)
    batch = batch_to_device(smoke.adapt_batch(rng, target, source), device)
    step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    first, last = spans[0][0], max(end for _, end in spans)
    span_ms = (last - first) / 1e3
    print(f"profiled {args.steps} steps: {window_ms / args.steps:.3f} ms "
          f"per step (host clock, profiler on); kernels from first to "
          f"last {span_ms:.3f} ms, busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / 1e3 / window_ms:.1f}% of the window, idle "
          f"{100 * (1 - busy / 1e3 / window_ms):.1f}%; "
          f"{len(kernels) / args.steps:.0f} kernels per step")

    by_name, by_class = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + us)
        label = classify(e.name)
        count, total = by_class.get(label, (0, 0.0))
        by_class[label] = (count + 1, total + us)
    per_step = busy / args.steps / 1e3
    print(f"device time per step by kernel class (of {per_step:.3f} ms "
          "busy):")
    for label, (count, us) in sorted(by_class.items(),
                                     key=lambda kv: -kv[1][1]):
        ms = us / args.steps / 1e3
        print(f"  {label:18s} {ms:9.3f} ms  {100 * ms / per_step:5.1f}%  "
              f"{count / args.steps:7.0f} launches")
    print("top kernels per step:")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (count, us) in top[:40]:
        print(f"  {us / args.steps / 1e3:9.3f} ms {count / args.steps:6.0f}x "
              f"[{classify(name)}] {name[:110]}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
