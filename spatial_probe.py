"""How far the row split (``tpu.spatial_shard``) and one process drift
apart on one card, and why: the spread that ``chip_smoke.py`` phase 14
holds its float32 step and its stream to.

    python3 spatial_probe.py

Two ranks share card 0 over gloo, from phase 4's calibrated ResNet-101
weights (seeded), on phase 14's published batches:

1. the float32 step (TF32 off) on 3 seeded batches under cuDNN's default
   algorithms, its deterministic ones, and with cuDNN off: each live
   module's gradient distance (relative L2) of the row split from one
   process, of one process from itself run again, and of each from the
   one-process float64 step;
2. phase 7's stream for 6 frames with float64 modules, the row split
   and one process twice: each frame's abs_rel and RMSE and, after the
   stream, the largest difference of the depth head's parameters.

Prints one JSON line per part, the card's name and power limit first.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BATCHES = 3
SETTINGS = ("default", "deterministic", "no_cudnn")


def float32_spread(torch, device, modules):
    """Part 1 on this rank; rank 0's distances by setting and batch."""
    import numpy as np
    import chip_smoke as cs
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    target, source = (cs.HEIGHT, cs.WIDTH), (cs.SOURCE_HEIGHT,
                                             cs.SOURCE_WIDTH)
    cfg = cs.adapt_config(target, source)
    cfg.tpu.compute_dtype = "float32"
    cfg.adapt.mixup.general.geom_augment = True
    step = make_adapt_step(
        cfg, list(cfg.semantics.class_weights), has_replay=True,
        num_mixup=cs.NUM_MIXUP, mixup_groups=(("cut_mixup", cs.NUM_MIXUP),),
        fused_mixup=True,
        eval_forward=build_eval_forward(cfg, cs.THINGS, cs.NUM_CLASSES))
    mods = cs.with_compute_dtype(torch, modules, torch.float32)

    def run(batch, noise, dtype):
        return cs.spatial_step_run(torch, step, cfg,
                                   copy.deepcopy(mods).to(device, dtype),
                                   cs.float_frames(torch, batch, dtype),
                                   noise, device)

    def grads(ours, ref):
        return cs.spatial_distances(torch, ours, ref)["grad_rel_l2"]

    out = {}
    for setting in SETTINGS:
        torch.backends.cudnn.deterministic = setting == "deterministic"
        torch.backends.cudnn.enabled = setting != "no_cudnn"
        rows = []
        for index in range(BATCHES):
            rng = np.random.default_rng(cs.SEED + 14 + index)
            batch = cs.spatial_batch(rng, target, source)
            noise = cs.automask_noise(torch, rng, target, source,
                                      cfg.depth.num_recon_scales)
            with spatial.rows():
                split = run(batch, noise, torch.float32)
            if parallel.rank() == 0:
                with parallel.replicated():
                    one = run(batch, noise, torch.float32)
                    again = run(batch, noise, torch.float32)
                    truth = run(batch, noise, torch.float64)
                rows.append({"split_one": grads(split, one),
                             "one_again": grads(again, one),
                             "split_float64": grads(split, truth),
                             "one_float64": grads(one, truth)})
            parallel.barrier()
        out[setting] = rows
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.enabled = True
    return out


def float64_streams(torch, device, modules):
    """Part 2 on this rank; rank 0's per-frame depth metrics and depth
    head differences."""
    import numpy as np
    import chip_smoke as cs
    from codeps_torch import parallel
    from codeps_torch.tasks import adapt_loop
    target, source = (cs.HEIGHT, cs.WIDTH), (cs.SOURCE_HEIGHT,
                                             cs.SOURCE_WIDTH)
    frames = []
    update = adapt_loop.AdaptationRunner._update_metrics

    def recording(self, stats, results, pan_gt):
        frames.append({k: float(np.asarray(stats[k]))
                       for k in ("d_abs_rel", "d_rmse")})
        return update(self, stats, results, pan_gt)
    adapt_loop.AdaptationRunner._update_metrics = recording

    def stream(split):
        cfg = cs.stream_config(target, source)
        cfg.tpu.spatial_shard = split
        cfg.tpu.compute_dtype = "float32"
        mods = cs.with_compute_dtype(torch, copy.deepcopy(modules),
                                     torch.float32).to(device, torch.float64)
        runner, _ = cs.build_stream(cfg, mods, device, cs.SEED,
                                    noise=cs.numpy_noise(torch, cs.SEED,
                                                         device))
        frames.clear()
        runner.run(max_frames=cs.SPATIAL_FRAMES)
        head = torch.cat([p.detach().reshape(-1).cpu() for p in
                          runner.state.student.depth_head.parameters()])
        return list(frames), head

    try:
        split = stream(True)
        out = None
        if parallel.rank() == 0:
            with parallel.replicated():
                one, again = stream(False), stream(False)
            out = {"frames": [{k: [s[k], a[k], b[k]] for k in s}
                              for s, a, b in zip(split[0], one[0],
                                                 again[0])],
                   "depth_head_split_one": float(
                       (split[1] - one[1]).abs().max()),
                   "depth_head_one_again": float(
                       (again[1] - one[1]).abs().max())}
        parallel.barrier()
    finally:
        adapt_loop.AdaptationRunner._update_metrics = update
    return out


def probe_rank(rank, world, port, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch
    from codeps_torch import parallel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    modules = torch.load(Path(out_dir) / "modules.pt", weights_only=False)
    with parallel.process_group(device):
        numbers = {"float32_spread": float32_spread(torch, device, modules),
                   "float64_streams": float64_streams(torch, device,
                                                      modules)}
    if rank == 0:
        (Path(out_dir) / "probe.json").write_text(json.dumps(numbers))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("spatial_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    import torch.multiprocessing as torch_mp
    from codeps_torch.models import CodepsNet, build_modules, init_params
    from codeps_torch.ops._build import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    build(["grouping"])
    device = torch.device("cuda")
    cfg = cs.slice_config()
    rng = np.random.default_rng(cs.SEED)
    frame = rng.integers(0, 256, (1, cs.HEIGHT, cs.WIDTH, 3),
                         dtype=np.uint8)
    modules = init_params(build_modules(cfg, cs.NUM_CLASSES, device=device),
                          seed=cs.SEED, device=device)
    cs.calibrate_batch_norm(torch, modules, frame)
    net = CodepsNet(modules, thing_list=cs.THINGS, device=device)
    shift = float(0.1 - torch.quantile(
        net(frame, mode="eval")["center"].flatten(), 0.9998))
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.add_(shift)
    del net
    t0 = time.perf_counter()
    # the weights and rank 0's numbers pass through a directory of the
    # checkout, removed after
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as out:
        torch.save(modules.cpu(), Path(out) / "modules.pt")
        torch_mp.spawn(probe_rank, args=(2, cs.free_port(), out),
                       nprocs=2, join=True)
        numbers = json.loads((Path(out) / "probe.json").read_text())
    for part, value in numbers.items():
        print(json.dumps({part: value}))
    print(f"spatial_probe: {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
