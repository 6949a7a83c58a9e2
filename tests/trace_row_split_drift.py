"""Where a float32 row split drifts from one process, in the port and in
the JAX package, on the same batches (CPU only; a tool, not a test).

    JAX_PLATFORMS=cpu python tests/trace_row_split_drift.py OUT_DIR

The published adaptation step (ResNet-18 encoders at 64x96, the frozen
depth encoder and instance head, the composed cut mixups, the teacher
eval with panoptic fusion) from the JAX package's initial weights, on
three seeded uint8 batches (SEEDS), four ways in float32:

  - the JAX package's single-device step (``make_adapt_step``);
  - the same jitted step with the batch placed by the JAX package's own
    row split (``codeps_tpu.parallel.shard_adapt_batch_spatial``: every
    image leaf's height sharded, GSPMD inserts the halos) on meshes of 2
    and 8 CPU devices;
  - the port's step in one process and split over 2 gloo ranks
    (``spatial.rows()``; the ranks are this script run as
    ``RANK=r WORLD_SIZE=2 ... trace_row_split_drift.py OUT_DIR``), with
    the JAX step's automask noise.

For each split against its own single run it prints and writes
``OUT_DIR/drift.json``: the losses' relative distance, each live
module's gradient of the first step (JAX: Adam's first moment over
``1 - b1``) by relative L2, the ratio of the split's and the single
run's distances from the port's float64 step on the same weights, batch
and noise (phase 14 (b)'s measure), the parameters after each step (max
|diff| / (1 + max |value|)), and the pixels of the teacher eval's
panoptic map that differ, with their ids on both sides.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

if os.environ.get("RANK") is None:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _spatial_worker as worker  # noqa: E402

# the batch of tests/test_torch_spatial.py's JAX step, and two more
SEEDS = (50, 51, 52)


def _flips(ours, ref, limit=12):
    """The differing pixels of two (1, H, W) panoptic maps: their count,
    the first ``limit`` as (row, column, ours, ref), and the ids on each
    side that any differing pixel carries."""
    ours, ref = np.asarray(ours)[0], np.asarray(ref)[0]
    rows, cols = np.nonzero(ours != ref)
    return {"pixels": int(rows.size), "share": float(rows.size / ours.size),
            "first": [[int(r), int(c), int(ours[r, c]), int(ref[r, c])]
                      for r, c in list(zip(rows, cols))[:limit]],
            "ids": [sorted({int(v) for v in ours[rows, cols]}),
                    sorted({int(v) for v in ref[rows, cols]})]}


def _param_err(ours, ref):
    return {name: max(float(np.abs(np.asarray(o, np.float64) - r).max()
                            / (1.0 + np.abs(r).max()))
                      for o, r in zip(ours[name], ref[name]))
            for name in ref}


# ------------------------------------------------------------- the port

def port_runs(inputs, split):
    """The port's float32 steps on ``inputs`` (inside ``spatial.rows()``
    when ``split``): per step the metrics, the first step's gradients,
    the parameters after each step and the eval's panoptic map."""
    from codeps_torch.models import build_modules
    from codeps_torch.parallel import spatial
    from codeps_torch import parallel
    from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
    from codeps_torch.tasks.state import make_adapt_state
    cfg = worker.step_config()
    modules = build_modules(cfg, worker.NC, device="cpu")
    for name, sd in inputs["state_dicts"].items():
        getattr(modules, name).load_state_dict(sd, strict=True)
    step = make_adapt_step(cfg, [1.0] * worker.NC, has_replay=True,
                           num_mixup=worker.NUM_MIXUP,
                           eval_forward=build_eval_forward(cfg, worker.THINGS,
                                                           worker.NC))
    state = make_adapt_state(modules, worker.LR, ema_modules=worker.EMA,
                             frozen_modules=worker.FROZEN, ema_alpha=0.99,
                             seed=3, device="cpu")
    out = []
    context = spatial.rows() if split else parallel.replicated()
    with context:
        for batch, noise in zip(inputs["batches"], inputs["noise"]):
            draws = [torch.from_numpy(np.array(d)) for d in noise]
            metrics, _, results, _ = step(state, batch,
                                          noise=lambda shape: draws.pop(0))
            out.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": _grads(state.student),
                "params": {name: [p.detach().double().numpy() for p in
                                  getattr(state.student, name).parameters()]
                           for name in worker.LIVE},
                "panoptic": None if results is None
                else results["panoptic"].numpy()})
    return out


def port_float64_grads(inputs):
    """The first step's gradients of the port's float64 step on the same
    weights, with the uint8 frames normalized in float64."""
    from codeps_torch.models import build_modules
    from codeps_torch.ops.normalize import IMAGENET_MEAN, IMAGENET_STD
    from codeps_torch.tasks.adapt import make_adapt_step
    from codeps_torch.tasks.state import make_adapt_state
    cfg = worker.step_config()
    modules = build_modules(cfg, worker.NC, device="cpu")
    for name, sd in inputs["state_dicts"].items():
        getattr(modules, name).load_state_dict(sd, strict=True)
    modules = modules.double()
    step = make_adapt_step(cfg, [1.0] * worker.NC, has_replay=True,
                           num_mixup=worker.NUM_MIXUP)
    state = make_adapt_state(modules, worker.LR, ema_modules=worker.EMA,
                             frozen_modules=worker.FROZEN, ema_alpha=0.99,
                             seed=3, device="cpu")
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float64)

    def normalized(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = normalized(value)
            elif key in ("frames", "rgb") and value.dtype == np.uint8:
                out[key] = (torch.from_numpy(value).double() / 255.0
                            - mean) / std
            else:
                out[key] = value
        return out
    draws = [torch.from_numpy(np.array(d)) for d in inputs["noise"][0]]
    step(state, normalized(inputs["batches"][0]),
         noise=lambda shape: draws.pop(0))
    return _grads(state.student)


def _grads(student):
    """Each live module's gradients by parameter name, float64 numpy."""
    return {name: {key: p.grad.double().numpy() for key, p in
                   getattr(student, name).named_parameters()
                   if p.grad is not None}
            for name in worker.LIVE}


def rank_main(out_dir):
    torch.set_num_threads(1)
    from codeps_torch import parallel
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    with parallel.process_group("cpu"):
        split = port_runs(inputs, True)
        if parallel.rank() == 0:
            torch.save({"split": split, "one": port_runs(inputs, False)},
                       out_dir / "port.pt")
        parallel.barrier()


# ------------------------------------------------------------ the JAX side

def jax_runs(out_dir):
    """The JAX step single-device and row-split on 2 and 8 devices;
    writes the port's inputs (weights, batches, each step's noise)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from codeps_tpu.config import gen_config
    from codeps_tpu.models import build_modules, init_params
    from codeps_tpu.parallel import replicate, shard_adapt_batch_spatial
    from codeps_tpu.tasks import build_optimizer, make_adapt_state
    from codeps_tpu.tasks.adapt import build_eval_forward, make_adapt_step
    from codeps_torch.io import from_jax
    from test_torch_spatial import _jax_noise
    jcfg = gen_config(adapt=True, freeze=False)
    jcfg.model.po_depth_net.params.nof_layers = 18
    jcfg.model.pose_sflow_net.params.nof_layers = 18
    jcfg.semantics.class_weights = [1.0] * worker.NC
    jcfg.adapt.ema.semantic = True
    jcfg.adapt.ema.alpha = 0.99
    jcfg.tpu.compute_dtype = "float32"
    jmodules = build_modules(jcfg, num_classes=worker.NC)
    params, stats = init_params(jax.random.PRNGKey(0), jmodules,
                                (worker.H, worker.W))
    params, stats = jax.tree.map(np.array, (params, stats))
    tx = build_optimizer(jcfg, worker.LR, frozen_modules=worker.FROZEN)
    step = make_adapt_step(
        jmodules, jcfg, tx, class_weights=[1.0] * worker.NC,
        ema_modules=worker.EMA, frozen_modules=worker.FROZEN,
        has_replay=True, num_mixup=worker.NUM_MIXUP, donate=False,
        eval_forward=build_eval_forward(jmodules, jcfg, worker.THINGS))
    batches = [worker.step_batch(seed, np.uint8) for seed in SEEDS]

    def fresh():
        return make_adapt_state(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, stats), tx, jax.random.PRNGKey(2),
            ema_modules=worker.EMA, frozen_modules=worker.FROZEN,
            ema_alpha=0.99)

    def run(mesh):
        state = fresh() if mesh is None else replicate(fresh(), mesh)
        out, noise = [], []
        for batch in batches:
            noise.append(_jax_noise(state.rng))
            placed = (jax.tree.map(jnp.asarray, batch) if mesh is None
                      else shard_adapt_batch_spatial(batch, mesh))
            state, metrics, _, results, _ = step(state, placed)
            mu = state.opt_state.inner_states["trained"].inner_state[0].mu
            out.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "mu_tree": {name: jax.tree.map(np.asarray, mu[name])
                            for name in worker.LIVE},
                "params": {name: [np.asarray(x) for x in jax.tree.leaves(
                    state.params[name])] for name in worker.LIVE},
                "panoptic": np.asarray(results["panoptic"])})
        return out, noise

    single, noise = run(None)
    cfg = worker.step_config()
    torch.save({"state_dicts": from_jax.state_dicts_from_jax(params, stats,
                                                             cfg),
                "batches": batches, "noise": noise}, out_dir / "inputs.pt")
    splits = {n: run(Mesh(np.asarray(jax.devices()[:n]), ("data",)))[0]
              for n in (2, 8)}
    return single, splits, stats


def _jax_grads(run, stats):
    """The first step's gradients of the JAX run by the port's parameter
    names: Adam's first moment after one step over 1 - b1."""
    from codeps_torch.io import from_jax
    convert = {"backbone_pose_sflow": lambda p: from_jax.resnet_encoder(
        p, stats["backbone_pose_sflow"], 18),
        "depth_head": from_jax.depth_head, "pose_head": from_jax.pose_head,
        "semantic_head": lambda p: from_jax.semantic_head(p, True)}
    return {name: {key: np.asarray(v, np.float64) / (1.0 - 0.9) for key, v
                   in convert[name](run[0]["mu_tree"][name]).items()}
            for name in worker.LIVE}


def _dict_rel_l2(ours, ref):
    """Relative L2 over a module's gradients by name (the keys of
    ``ref``)."""
    num = sum(float(((np.asarray(ours[k], np.float64) - v) ** 2).sum())
              for k, v in ref.items())
    den = sum(float((v ** 2).sum()) for v in ref.values())
    return float(np.sqrt(num / max(den, 1e-300)))


def main(out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    single, splits, jax_stats = jax_runs(out_dir)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _ddp_worker
    port = str(_ddp_worker.free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(out_dir)],
        env=_ddp_worker.env(RANK=str(rank), WORLD_SIZE="2",
                            LOCAL_RANK=str(rank), MASTER_PORT=port))
        for rank in range(2)]
    _ddp_worker.finish(procs)
    port_out = torch.load(out_dir / "port.pt", weights_only=False)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    truth = port_float64_grads(inputs)
    report = {}

    # the float64 truth is the port's one-process step on the same
    # weights, batch and noise
    single_grads = _jax_grads(single, jax_stats)
    for n, run in splits.items():
        part = {"steps": []}
        for k, (ours, ref) in enumerate(zip(run, single)):
            entry = {
                "loss_rel": {key: abs(ours["metrics"][key] - v)
                             / max(abs(v), 1e-30)
                             for key, v in ref["metrics"].items()},
                "param_err": _param_err(ours["params"], ref["params"]),
                "panoptic": _flips(ours["panoptic"], ref["panoptic"])}
            if k == 0:
                grads = _jax_grads(run, jax_stats)
                entry["grad_rel_l2"] = {
                    name: _dict_rel_l2(grads[name], single_grads[name])
                    for name in worker.LIVE}
                entry["to_float64"] = {
                    name: [_dict_rel_l2(grads[name], truth[name]),
                           _dict_rel_l2(single_grads[name], truth[name])]
                    for name in worker.LIVE}
            part["steps"].append(entry)
        report[f"jax {n} devices"] = part
    part = {"steps": []}
    split, one = port_out["split"], port_out["one"]
    for k, (ours, ref) in enumerate(zip(split, one)):
        entry = {
            "loss_rel": {key: abs(ours["metrics"][key] - v)
                         / max(abs(v), 1e-30)
                         for key, v in ref["metrics"].items()},
            "param_err": _param_err(ours["params"],
                                    {n: [np.asarray(x) for x in v]
                                     for n, v in ref["params"].items()}),
            "panoptic": _flips(ours["panoptic"], ref["panoptic"])}
        if k == 0:
            entry["grad_rel_l2"] = {
                name: _dict_rel_l2(ours["grads"][name], ref["grads"][name])
                for name in worker.LIVE}
            entry["to_float64"] = {
                name: [_dict_rel_l2(ours["grads"][name], truth[name]),
                       _dict_rel_l2(ref["grads"][name], truth[name])]
                for name in worker.LIVE}
        part["steps"].append(entry)
    report["port 2 ranks"] = part
    (out_dir / "drift.json").write_text(json.dumps(report, indent=1))
    for name, part in report.items():
        for k, entry in enumerate(part["steps"]):
            print(f"{name}, step {k + 1}: loss_total rel "
                  f"{entry['loss_rel']['loss_total']:.3g}; params "
                  + ", ".join(f"{m} {v:.3g}"
                              for m, v in entry["param_err"].items())
                  + (("; gradients " + ", ".join(
                      f"{m} {v:.3g}" for m, v in
                      entry["grad_rel_l2"].items())) if k == 0 else "")
                  + (("; to float64 split / single " + ", ".join(
                      f"{m} {a:.3g} / {b:.3g} ({a / b:.3f})" for m, (a, b)
                      in entry["to_float64"].items()))
                     if "to_float64" in entry else "")
                  + f"; panoptic pixels differing "
                  f"{entry['panoptic']['pixels']} "
                  f"({entry['panoptic']['share']:.4g}), ids "
                  f"{entry['panoptic']['ids']}, first "
                  f"{entry['panoptic']['first'][:6]}")


if __name__ == "__main__":
    if os.environ.get("RANK") is not None:
        rank_main(Path(sys.argv[1]))
    else:
        main(Path(sys.argv[1]))
