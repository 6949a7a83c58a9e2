"""One rank of the row-split checks of ``tests/test_torch_spatial.py``.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_spatial_worker.py OUT_DIR

joins the gloo process group (``codeps_torch.parallel.process_group``) on
the CPU and runs every check in turn, on this rank's rows
inside ``spatial.rows()`` against the same port code in one process
(``parallel.replicated()``, which every rank or rank 0 runs itself).
Writes ``OUT_DIR/spatial_<rank>.pt``: a dict of each check's distances
and results. The JAX step's inputs come from ``OUT_DIR/jax_inputs.pt``
and the synthetic dataset trees from ``OUT_DIR``, both written by the
test. Imports no JAX.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch

H, W = 64, 96
NC = 14
THINGS = (9, 10, 11, 12, 13)
LR = 1e-4
NUM_SOURCE = NUM_MIXUP = 2
NUM_REPLAY = 1
FROZEN = ("backbone_po_depth", "instance_head")
EMA = ("semantic_head",)
LIVE = ("backbone_pose_sflow", "depth_head", "pose_head", "semantic_head")
HALO_CASES = ((1, 1, "zeros"), (3, 2, "zeros"), (1, 0, "-inf"),
              (1, 1, "reflect"), (2, 1, "replicate"), (0, 1, "zeros"))
RUNNER_FRAMES = 3
# seconds a rank waits for the JAX step's inputs
TIMEOUT = 900


def relative(ours, ref) -> float:
    """max |ours - ref| / max |ref| (0 for equal tensors)."""
    ours, ref = ours.detach().double(), ref.detach().double()
    err = float((ours - ref).abs().max())
    return err / max(float(ref.abs().max()), 1e-300) if err else 0.0


def relative_l2(ours, ref) -> float:
    ours, ref = ours.detach().double(), ref.detach().double()
    return float(torch.linalg.vector_norm(ours - ref)
                 / torch.linalg.vector_norm(ref).clamp(min=1e-300))


def step_config(compute_dtype="float32"):
    """The published adaptation freezing at 64x96 with ResNet-18 encoders
    (``tests/test_torch_adapt.py``'s setup)."""
    from codeps_torch.config import gen_config
    cfg = gen_config(adapt=True, freeze=False)
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.adapt.ema.semantic = True
    cfg.adapt.ema.alpha = 0.99
    cfg.adapt.mixup.general.geom_augment = True
    cfg.tpu.compute_dtype = compute_dtype
    return cfg


def step_batch(seed, dtype=np.float64, fused=False, height=H):
    """An adaptation batch at ``height`` x W; float frames are taken as
    normalized. ``fused`` gives the raw materials of two cut mixups with
    the camera warp in place of composed samples."""
    from codeps_torch.tasks.mixup_prep import c2c_prewarp
    rng = np.random.default_rng(seed)

    def cams(n, f):
        return np.tile(np.asarray([[f, f, W / 2, height / 2]], np.float32),
                       (n, 1))

    def images(*shape):
        if dtype == np.uint8:
            return rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        return rng.normal(0, 1, (*shape, 3)).astype(dtype)

    batch = {
        "target": {"frames": images(1, 3, height, W),
                   "camera": cams(1, 30.0)},
        "source": {
            "frames": images(NUM_SOURCE, 3, height, W),
            "camera": cams(NUM_SOURCE, 28.0),
            "semantic": rng.integers(0, NC, (NUM_SOURCE, height, W)).astype(
                np.int32),
            "semantic_weights": rng.uniform(
                0.5, 2.0, (NUM_SOURCE, height, W)).astype(np.float32),
            "center": rng.uniform(0, 1, (NUM_SOURCE, height, W, 1)).astype(
                np.float32),
            "offset": rng.normal(0, 4, (NUM_SOURCE, height, W, 2)).astype(
                np.float32)},
        "target_replay": {"frames": images(NUM_REPLAY, 3, height, W),
                          "camera": cams(NUM_REPLAY, 30.0)},
        "eval_gt": {
            "semantic": rng.integers(0, NC, (1, height, W)).astype(np.int32),
            "depth_gt": np.where(rng.random((1, height, W)) < 0.2, 0.0,
                                 rng.uniform(1, 60, (1, height, W))).astype(
                np.float32)},
    }
    if fused:
        batch["mixup"] = {
            "rgb_src": images(NUM_MIXUP, height, W),
            "semantic_src": rng.integers(0, NC, (NUM_MIXUP, height, W))
            .astype(np.int32),
            "rgb_tgt": images(NUM_MIXUP, height, W),
            "prewarp": c2c_prewarp(cams(NUM_MIXUP, 30.0),
                                   cams(NUM_MIXUP, 24.0), (height, W),
                                   (height, W)),
            "cut_cells": np.stack([rng.choice(8, 2, replace=False)
                                   for _ in range(NUM_MIXUP)]).astype(
                                       np.int32)}
    else:
        batch["mixup"] = {
            "rgb": images(NUM_MIXUP, height, W),
            "semantic": rng.integers(0, NC, (NUM_MIXUP, height, W)).astype(
                np.int32)}
    return batch


def build_step(cfg, fused=False):
    """(seeded modules, the step) of ``step_config``."""
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=4,
                          device="cpu")
    with torch.no_grad():
        # centers over the threshold, so that the fusion has instances
        modules.instance_head.center_head.net.conv.bias.fill_(0.12)
    step = make_adapt_step(cfg, [1.0] * NC, has_replay=True,
                           num_mixup=NUM_MIXUP, fused_mixup=fused,
                           eval_forward=build_eval_forward(cfg, THINGS, NC))
    return modules, step


def run_steps(modules, step, batches, frozen=FROZEN, noise=None):
    """Steps from a fresh state on ``batches``: per step (metrics as
    floats, the live modules' flat gradients, replay features, eval
    results and stats), and the student's and teacher's state dicts
    after the last."""
    from codeps_torch.tasks.state import make_adapt_state
    state = make_adapt_state(modules, LR, ema_modules=EMA,
                             frozen_modules=frozen, ema_alpha=0.99, seed=3,
                             device="cpu")
    out = []
    for batch in batches:
        metrics, features, results, stats = step(state, batch, noise=noise)
        grads = {name: {key: p.grad.clone() for key, p in
                        getattr(state.student, name).named_parameters()
                        if p.grad is not None}
                 for name in state.student.module_names()
                 if name not in frozen}
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": grads, "features": features.clone(),
                    "results": results, "stats": stats})
    sds = {role: {name: {k: v.clone() for k, v in
                         getattr(getattr(state, role), name)
                         .state_dict().items()}
                  for name in modules.module_names()}
           for role in ("student", "teacher")}
    return out, sds


# ------------------------------------------------------------- checks

def check_halo(out):
    """``halo_rows`` and ``gather_rows``, forward and backward, against
    the padding and concatenation of the whole tensor in one process, in
    float64: every rank's output and input gradient, with the loss of
    rank r its output times the weights ``weights[r]``."""
    import torch.nn.functional as F
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    ranks, rank = parallel.world_size(), parallel.rank()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 3, H, 5, generator=g, dtype=torch.float64)
    rows = H // ranks
    result = {}
    for top, bottom, edge in HALO_CASES:
        weights = torch.randn(ranks, 2, 3, rows + top + bottom, 5,
                              generator=g, dtype=torch.float64)
        with spatial.rows():
            mine = spatial.rows_of(x).clone().requires_grad_(True)
            got = spatial.halo_rows(mine, top, bottom, edge)
            finite = torch.where(torch.isfinite(got), got, 0.0)
            (finite * weights[rank]).sum().backward()
        whole = x.clone().requires_grad_(True)
        mode = {"zeros": "constant", "-inf": "constant"}.get(edge, edge)
        padded = F.pad(whole, (0, 0, top, bottom), mode=mode,
                       value=float("-inf") if edge == "-inf" else 0.0) \
            if mode == "constant" else F.pad(whole, (0, 0, top, bottom),
                                             mode=mode)
        loss = 0.0
        for r in range(ranks):
            part = padded[..., r * rows:r * rows + rows + top + bottom, :]
            loss = loss + (torch.where(torch.isfinite(part), part, 0.0)
                           * weights[r]).sum()
        loss.backward()
        expect = padded[..., rank * rows:rank * rows + rows + top + bottom,
                        :]
        result[f"halo {top} {bottom} {edge}"] = {
            "out": float((torch.where(torch.isfinite(got), got, 0.0)
                          - torch.where(torch.isfinite(expect), expect, 0.0))
                         .abs().max()),
            "inf_equal": bool(torch.equal(torch.isinf(got),
                                          torch.isinf(expect))),
            "grad": relative(mine.grad,
                             whole.grad[..., rank * rows:(rank + 1) * rows,
                                        :])}
    weights = torch.randn(ranks, *x.shape, generator=g, dtype=torch.float64)
    with spatial.rows():
        mine = spatial.rows_of(x).clone().requires_grad_(True)
        got = spatial.gather_rows(mine)
        (got * weights[rank]).sum().backward()
    result["gather"] = {
        "out": float((got - x).abs().max()),
        "grad": relative(mine.grad, weights.sum(0)[..., rank * rows:
                                                   (rank + 1) * rows, :])}
    out["halo"] = result


def _compare_forward(fn, inputs, params, rows_axes, out_axes):
    """``fn(*inputs)`` on this rank's rows (inputs cut along
    ``rows_axes``, None for a whole input) against one process: the
    relative distance of each output (gathered along ``out_axes``, None
    for a value that is a share) and of the gradient of a seeded
    weighted sum of the outputs by the inputs and by ``params``
    (summed over the ranks)."""
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    g = torch.Generator().manual_seed(11)
    with parallel.replicated():
        ref_in = [x.clone().requires_grad_(x.is_floating_point())
                  for x in inputs]
        ref = fn(*ref_in)
        weights = [torch.randn(o.shape, generator=g, dtype=torch.float64)
                   for o in ref]
        sum(((o.double() * w).sum() for o, w in zip(ref, weights))).backward()
        ref_param = [p.grad.clone() for p in params]
        ref_in_grad = [x.grad for x in ref_in]
        for p in params:
            p.grad = None
    with spatial.rows():
        mine = [(x if axis is None else spatial.rows_of(x, axis))
                .clone().requires_grad_(x.is_floating_point())
                for x, axis in zip(inputs, rows_axes)]
        outs = fn(*mine)
        loss = 0.0
        for o, w, axis in zip(outs, weights, out_axes):
            # a gathered output weighs its rows; a loss is this rank's
            # share, and the shares add up to the value
            loss = loss + (o.double() * (w if axis is None
                                         else spatial.rows_of(w, axis))).sum()
        loss.backward()
        parallel.sum_gradients(params)
        whole = [spatial.gather_rows(o, axis) if axis is not None
                 else parallel.all_reduce(o.detach())
                 for o, axis in zip(outs, out_axes)]
        in_grads = [None if x.grad is None or axis is None else
                    spatial.gather_rows(x.grad, axis)
                    for x, axis in zip(mine, rows_axes)]
    result = {f"out{i}": relative(o, r) for i, (o, r)
              in enumerate(zip(whole, ref))}
    result.update({f"in_grad{i}": relative(gr, r)
                   for i, (gr, r) in enumerate(zip(in_grads, ref_in_grad))
                   if gr is not None})
    if params:
        result["param_grad"] = max(relative_l2(p.grad, r)
                                   for p, r in zip(params, ref_param))
    for p in params:
        p.grad = None
    return result


def check_modules(out):
    """Each ported module and loss on 2 ranks against one process, in
    float64 (the losses' float32 parts as they are)."""
    from codeps_torch.geometry.warp import warp_image
    from codeps_torch.losses import (binary_mask_loss, center_loss,
                                     edge_aware_smoothness_loss, offset_loss,
                                     reconstruction_loss, semantic_loss)
    from codeps_torch.models.heads import (DepthHead, InstanceHead,
                                           SemanticHead)
    from codeps_torch.models.resnet import keep_running_stats, make_encoder
    from codeps_torch.ops.resize import (resize_bilinear_nchw,
                                         resize_nearest_nchw)
    from codeps_torch.parallel import spatial
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    image = torch.randn(2, 3, H, W, generator=g, dtype=torch.float64)
    result = {}
    for layers in (18, 50):
        for train in (False, True):
            encoder = make_encoder(layers).double().train(train)
            keep_running_stats(encoder)
            result[f"encoder{layers} train={train}"] = _compare_forward(
                encoder, [image], list(encoder.parameters()), [-2],
                [-2] * 5)
    encoder = make_encoder(18).double().eval()
    with torch.no_grad():
        feats = [f.detach() for f in encoder(image)]
    heads = {
        "depth head": (DepthHead(encoder.num_ch_enc).double(),
                       lambda m, *f: list(m(list(f)))),
        "semantic head guda": (SemanticHead(encoder.num_ch_enc, NC,
                                            use_guda_fusion=True).double(),
                               lambda m, *f: [m(list(f))]),
        "semantic head reflect": (SemanticHead(encoder.num_ch_enc,
                                               NC).double(),
                                  lambda m, *f: [m(list(f))]),
        "instance head": (keep_running_stats(InstanceHead(
            encoder.num_ch_enc, use_thing_mask=True).double().train()),
            lambda m, *f: list(m(list(f)))),
    }
    for name, (module, call) in heads.items():
        result[name] = _compare_forward(
            lambda *f, m=module, c=call: c(m, *f), feats,
            list(module.parameters()), [-2] * 5, [-2] * 3)
    small = torch.randn(2, 4, H // 2, 24, generator=g, dtype=torch.float64)
    for size, align in (((H, 48), True), ((H, 48), False), ((H // 4, 12),
                                                           False),
                        ((H // 2, 40), True)):
        # a row split's output size is its slab's
        result[f"resize {size} {align}"] = _compare_forward(
            lambda x, s=size, a=align: [resize_bilinear_nchw(
                x, (s[0] // spatial.count(), s[1]), a)],
            [small], [], [-2], [-2])
    result["resize nearest"] = _compare_forward(
        lambda x: [resize_nearest_nchw(x, (H // 8 // spatial.count(), 10))],
        [small], [], [-2], [-2])

    camera = torch.tensor([[30.0, 30.0, W / 2, H / 2]] * 2,
                          dtype=torch.float64)
    pose = torch.eye(4, dtype=torch.float64).repeat(2, 1, 1)
    pose[:, :3, 3] = torch.tensor([0.1, -0.05, 0.3], dtype=torch.float64)
    depth = 1.0 + 20 * torch.rand(2, 1, H, W, generator=g,
                                  dtype=torch.float64)
    neighbours = [torch.randn(2, 3, H, W, generator=g, dtype=torch.float64)
                  for _ in range(2)]
    result["warp"] = _compare_forward(
        lambda d: [warp_image(camera, neighbours[0], d, pose)], [depth], [],
        [-2], [-2])
    noise = [torch.randn(2, 2, H >> s, W >> s, generator=g)
             for s in range(5)]

    def recon(d, *images):
        draws = iter(noise)
        return [reconstruction_loss(camera, list(images), d, [pose, pose],
                                    per_sample=True,
                                    noise=lambda shape: next(draws),
                                    dtype=torch.float64)]
    result["reconstruction loss"] = _compare_forward(
        recon, [depth, image, *neighbours], [], [-2, None, None, None],
        [None])
    result["smoothness loss"] = _compare_forward(
        lambda d, i: [edge_aware_smoothness_loss(i, d)], [depth, image], [],
        [-2, None], [None])
    probs = torch.softmax(torch.randn(2, NC, H, W, generator=g,
                                      dtype=torch.float64), dim=1)
    labels = torch.randint(0, NC, (2, H, W), generator=g)
    pixel_weights = torch.rand(2, H, W, generator=g, dtype=torch.float64)
    result["semantic loss top-k"] = _compare_forward(
        lambda p, t, w: [semantic_loss(p, t, w, top_k_percent_pixels=0.2,
                                       dtype=torch.float64)],
        [probs, labels, pixel_weights], [], [-2, -2, -2], [None])
    center = torch.rand(2, H, W, 1, generator=g, dtype=torch.float64)
    offset = torch.randn(2, H, W, 2, generator=g, dtype=torch.float64)
    thing = torch.randint(0, 2, (2, H, W), generator=g)
    result["instance losses"] = _compare_forward(
        lambda c, o, pc, po, m, t: [center_loss(pc, c), offset_loss(po, o),
                                    binary_mask_loss(m, t)],
        [center, offset, center.flip(1), offset.flip(2), probs[:, :2], thing],
        [], [1, 1, 1, 1, -2, -2], [None] * 3)
    out["modules"] = result


def _step_distances(ours, ref):
    """Distances of a row-split run of ``run_steps`` from one process."""
    (steps, sds), (ref_steps, ref_sds) = ours, ref
    result = {"loss_rel": 0.0, "grad_rel_l2": {}, "features": 0.0,
              "eval_maps": 0.0, "sem_conf_equal": True,
              "panoptic_equal": True, "param_diff": 0.0, "checks": 0}
    for mine, theirs in zip(steps, ref_steps):
        for key, value in theirs["metrics"].items():
            result["loss_rel"] = max(result["loss_rel"], abs(
                mine["metrics"][key] - value) / max(abs(value), 1e-30))
        for name, grads in theirs["grads"].items():
            result["grad_rel_l2"][name] = max(
                result["grad_rel_l2"].get(name, 0.0),
                relative_l2(torch.cat([g.reshape(-1) for g in
                                       mine["grads"][name].values()]),
                            torch.cat([g.reshape(-1) for g in
                                       grads.values()])))
        result["features"] = max(result["features"],
                                 relative(mine["features"],
                                          theirs["features"]))
        if theirs["results"] is not None:
            for key in ("depth", "semantic_soft", "center", "offset"):
                result["eval_maps"] = max(result["eval_maps"], relative(
                    mine["results"][key], theirs["results"][key]))
            result["sem_conf_equal"] &= bool(torch.equal(
                mine["stats"]["sem_conf"], theirs["stats"]["sem_conf"]))
            result["panoptic_equal"] &= bool(torch.equal(
                mine["results"]["panoptic"], theirs["results"]["panoptic"]))
            result["checks"] += 1
    for role, modules in ref_sds.items():
        for name, sd in modules.items():
            for key, value in sd.items():
                if value.is_floating_point():
                    result["param_diff"] = max(result["param_diff"], float(
                        (sds[role][name][key].double()
                         - value.double()).abs().max()))
    return result


def check_step(out):
    """The float64 step on 2 ranks against one process (rank 0, under
    ``replicated()``) from the same weights, batches and generator state:
    the published freezing with the fused cut mixup for 2 steps, and a
    live depth encoder (train-mode BatchNorm over the rows) for one."""
    from codeps_torch import parallel
    from codeps_torch.parallel import spatial
    result = {}
    for name, fused, frozen, count in (
            ("published", True, FROZEN, 2),
            ("live encoder", False, ("instance_head",), 1)):
        cfg = step_config()
        modules, step = build_step(cfg, fused=fused)
        modules = modules.double()
        start = copy.deepcopy(modules)
        batches = [step_batch(30 + i, fused=fused) for i in range(count)]
        with spatial.rows():
            ours = run_steps(modules, step, batches, frozen)
        steps = ours[0]
        result[name] = {"metrics": [s["metrics"] for s in steps],
                        "eval_on_followers": [s["results"] is None
                                              for s in steps]}
        if parallel.rank() == 0:
            with parallel.replicated():
                ref = run_steps(start, step, batches, frozen)
            result[name].update(_step_distances(ours, ref))
        parallel.barrier()
    out["step"] = result


def check_jax_step(out, inputs_path):
    """The float32 step from the JAX package's weights and batch with its
    global noise, on this rank's rows: rank 0's metrics, gradients,
    features, eval results and stats for the test to hold against JAX,
    and those of the one-process step (the control). The test writes the
    inputs while the other checks run."""
    import time
    waited = 0.0
    while not inputs_path.exists():
        if waited > TIMEOUT:
            raise TimeoutError(f"no {inputs_path}")
        time.sleep(0.5)
        waited += 0.5
    from codeps_torch import parallel
    from codeps_torch.models import build_modules
    from codeps_torch.parallel import spatial
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    inputs = torch.load(inputs_path, weights_only=False)
    cfg = step_config()
    modules = build_modules(cfg, NC, device="cpu")
    for name, sd in inputs["state_dicts"].items():
        getattr(modules, name).load_state_dict(sd, strict=True)
    step = make_adapt_step(cfg, [1.0] * NC, has_replay=True,
                           num_mixup=NUM_MIXUP,
                           eval_forward=build_eval_forward(cfg, THINGS, NC))
    draws = list(inputs["noise"])

    def noise(shape):
        draw = torch.from_numpy(np.array(draws.pop(0)))
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return draw

    start = copy.deepcopy(modules)
    with spatial.rows():
        steps, _ = run_steps(modules, step, [inputs["batch"]], FROZEN,
                             noise=noise)
    out["jax"] = steps[0] if parallel.rank() == 0 else {
        "metrics": steps[0]["metrics"]}
    if parallel.rank() == 0:
        # the control: the one-process step on the same inputs
        draws = list(inputs["noise"])
        with parallel.replicated():
            out["jax"]["one_process"] = run_steps(
                start, step, [inputs["batch"]], FROZEN, noise=noise)[0][0]
    parallel.barrier()


def runner_config(root, spatial_shard):
    from codeps_torch.config import gen_config
    cfg = gen_config(adapt=True, freeze=False)
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.name = "kitti_360"
    cfg.dataset.path = str(root / "k360")
    cfg.dataset.feed_img_size = [H, W]
    cfg.dataset.center_heatmap_sigma = 4
    cfg.adapt.source_dataset.name = "cityscapes"
    cfg.adapt.source_dataset.path = str(root / "cs")
    cfg.adapt.source_dataset.feed_img_size = [H, W]
    cfg.adapt.replay_sampler.nof_source_samples = 2
    cfg.adapt.replay_sampler.nof_target_samples = 1
    cfg.adapt.replay_buffer.maximize_diversity = True
    cfg.adapt.replay_buffer.target_size = 3
    cfg.adapt.replay_buffer.similarity_threshold = 1.01
    cfg.adapt.mixup.general.nof_samples = 2
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup", "class_mixup"]
    cfg.adapt.ema.semantic = True
    cfg.adapt.model.backbone_po_depth = False
    cfg.adapt.model.instance = False
    cfg.semantics.class_weights = [1.0] * NC
    cfg.losses.weights.semantic_class_mixup = 1.0
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.spatial_shard = spatial_shard
    cfg.freeze()
    return cfg


def stream(root, spatial_shard):
    """(meters' values, buffer ids, the runner's step count) of a
    RUNNER_FRAMES-frame stream of the synthetic KITTI-360 tree."""
    import random
    from codeps_torch.data.cityscapes import Cityscapes
    from codeps_torch.data.kitti_360 import Kitti360
    from codeps_torch.data.replay_buffer import ReplayBuffer
    from codeps_torch.models import build_modules, init_params
    from codeps_torch.tasks.adapt_loop import AdaptationRunner
    cfg = runner_config(root, spatial_shard)
    target = Kitti360("sequence", cfg.dataset, return_depth=True,
                      sequences=["03"], sequence_reference_mode="rgb")
    buffer = ReplayBuffer(target, cfg.adapt, "train",
                          rng=random.Random(7))
    buffer.initialize_source_buffer(
        Cityscapes("train", cfg.adapt.source_dataset), None)
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=0,
                          device="cpu")
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.fill_(0.12)
    runner = AdaptationRunner(cfg, modules, buffer, seed=1, device="cpu",
                              verbose=False)
    meters = runner.run(max_frames=RUNNER_FRAMES)
    values = {f"{group}.{name}": float(meter.value)
              for group in ("losses", "metrics")
              for name, meter in meters[group].items()
              if np.ndim(meter.value) == 0}
    ids = {key: np.asarray(value).tolist()
           for key, value in buffer.buffer_indices.items()}
    return {"values": values, "ids": ids,
            "steps": len(runner.step_times),
            "row_times": runner.row_times}


def check_runner(out):
    """The spatial runner on 2 ranks against the one-process runner (rank
    0, ``replicated()``) on the same tree, weights and seeds."""
    from codeps_torch import parallel
    root = Path(out["root"])
    result = {"spatial": stream(root, True)}
    if parallel.rank() == 0:
        with parallel.replicated():
            result["one_process"] = stream(root, False)
    parallel.barrier()
    out["runner"] = result


def check_raises(out):
    """An indivisible height and the flow head under spatial sharding
    raise, on every rank, before any collective."""
    from codeps_torch.parallel import spatial
    result = {}
    cfg = step_config()
    modules, step = build_step(cfg)
    from codeps_torch.tasks.state import make_adapt_state
    state = make_adapt_state(modules, LR, ema_modules=EMA,
                             frozen_modules=FROZEN, device="cpu")
    try:
        with spatial.rows():
            step(state, step_batch(40, np.uint8, height=96))
        result["height"] = "no error"
    except ValueError as error:
        result["height"] = str(error)
    flow_cfg = runner_config(Path(out["root"]), True)
    flow_cfg.defrost()
    flow_cfg.model.make_sflow = True
    try:
        from codeps_torch.models import build_modules
        from codeps_torch.tasks.adapt_loop import AdaptationRunner
        AdaptationRunner(flow_cfg, build_modules(flow_cfg, NC, device="cpu"),
                         None, device="cpu")
        result["flow"] = "no error"
    except NotImplementedError as error:
        result["flow"] = str(error)
    out["raises"] = result


def main(argv):
    out_dir = Path(argv[1])
    torch.set_num_threads(1)
    from codeps_torch import parallel
    with parallel.process_group("cpu"):
        out = {"root": str(out_dir)}
        for check in (check_halo, check_modules, check_step, check_runner,
                      check_raises):
            check(out)
        check_jax_step(out, out_dir / "jax_inputs.pt")
        torch.save(out, out_dir / f"spatial_{parallel.rank()}.pt")
        parallel.barrier()


if __name__ == "__main__":
    main(sys.argv)
