"""The 2-rank spawn of ``tests/_spatial_worker.py`` and the JAX step that
``tests/test_torch_spatial.py`` and ``tests/test_torch_spatial_hybrid.py``
both read, and their checks against that step.

``spawned`` runs the spawn once for both files, also when xdist hands
them to different workers: the first to come runs it (while the test
process compiles the JAX step) under a file lock in the run's shared
temporary directory, the others wait on the lock and read its results.
"""

import fcntl
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_adapt_state as jax_make_adapt_state
from codeps_tpu.tasks.adapt import build_eval_forward as jax_eval_forward
from codeps_tpu.tasks.adapt import make_adapt_step as jax_make_adapt_step

import _ddp_worker
import _spatial_worker as worker
import test_torch_adapt
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)
from codeps_torch.io import from_jax

MODULE_TOL = 1e-10
PARAM_TOL = 1e-12
JAX_REL_TOL = 1e-4
JAX_GRAD_MAX = 2e-4
JAX_GRAD_L2 = 1e-4
# the split's gradient distance from JAX, as a multiple of the
# one-process port's own (``tests/test_torch_spatial.py``'s docstring)
CONTROL = 1.5
NUM_SCALES = 5


def _jax_noise(step_key, target, source, num_replay):
    """The automask normals one JAX step draws (the target and replay at
    ``target``'s (height, width), the source at ``source``'s), in the
    order the port asks for them (source scales, then the target and
    replay's), NCHW."""
    def scales(key, batch, size):
        out = []
        for s in range(NUM_SCALES):
            key, sub = jax.random.split(key)
            draw = jax.random.normal(
                sub, (batch, size[0] >> s, size[1] >> s, 2), jnp.float32)
            out.append(np.asarray(draw).transpose(0, 3, 1, 2))
        return out
    _, loss_key = jax.random.split(step_key)
    key, sub = jax.random.split(loss_key)
    source_noise = scales(sub, worker.NUM_SOURCE, source)
    _, sub = jax.random.split(key)
    return source_noise + scales(sub, 1 + num_replay, target)


def _jax_step(out_dir, batch, name="jax_inputs.pt"):
    """The JAX step on ``batch`` (uint8 frames, composed mixups): writes
    the port's inputs (state dicts, batch, noise) for the ranks to
    ``out_dir / name`` and returns Adam's first moment after the step,
    the JAX outputs, the batch statistics and the port's config."""
    target = batch["target"]["frames"].shape[2:4]
    source = batch["source"]["frames"].shape[2:4]
    num_replay = batch["target_replay"]["frames"].shape[0]
    jcfg = jax_gen_config(adapt=True, freeze=False)
    jcfg.model.po_depth_net.params.nof_layers = 18
    jcfg.model.pose_sflow_net.params.nof_layers = 18
    jcfg.semantics.class_weights = [1.0] * worker.NC
    jcfg.adapt.ema.semantic = True
    jcfg.adapt.ema.alpha = 0.99
    jcfg.tpu.compute_dtype = "float32"
    jmodules = jax_build_modules(jcfg, num_classes=worker.NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    target)
    params, stats = jax.tree.map(np.array, (params, stats))
    tx = jax_build_optimizer(jcfg, worker.LR, frozen_modules=worker.FROZEN)
    step = jax_make_adapt_step(
        jmodules, jcfg, tx, class_weights=[1.0] * worker.NC,
        ema_modules=worker.EMA, frozen_modules=worker.FROZEN,
        has_replay=True, num_mixup=worker.NUM_MIXUP, donate=False,
        eval_forward=jax_eval_forward(jmodules, jcfg, worker.THINGS))
    state = jax_make_adapt_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx, jax.random.PRNGKey(2), ema_modules=worker.EMA,
        frozen_modules=worker.FROZEN, ema_alpha=0.99)
    noise = _jax_noise(state.rng, target, source, num_replay)
    state, *results = step(state, jax.tree.map(jnp.asarray, batch))
    cfg = worker.step_config()
    partial = out_dir / f"{name}.tmp"
    torch.save({"state_dicts": from_jax.state_dicts_from_jax(params, stats,
                                                             cfg),
                "batch": batch, "noise": noise}, partial)
    os.replace(partial, out_dir / name)
    # Adam's first moment, all of the state the checks read
    mu = state.opt_state.inner_states["trained"].inner_state[0].mu
    return (jax.tree.map(np.array, mu), jax.tree.map(np.array, results),
            stats, cfg)


def _spawn(out):
    """Every check's results on each of the 2 ranks, and the outputs of
    the JAX steps on ``worker.step_batch``'s batch at 64x96 and, for the
    empty slabs, on ``tests/test_torch_adapt.py``'s first batch (target
    and 2 replay frames at 32x64, source and mixup at 32x96)."""
    make_cityscapes_tree(out / "cs", num_frames=6, width=worker.W,
                         height=worker.H)
    make_kitti360_tree(out / "k360", num_frames=6, width=worker.W,
                       height=worker.H)
    port = str(_ddp_worker.free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__).resolve()), str(out)],
        env=_ddp_worker.env(RANK=str(rank), WORLD_SIZE="2",
                            LOCAL_RANK=str(rank), MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    try:
        # the ranks run their other checks while JAX compiles its steps
        jax_out = _jax_step(out, worker.step_batch(50, np.uint8))
        jax_empty = _jax_step(out, test_torch_adapt._batch(1),
                              "jax_inputs_empty.pt")
    finally:
        _ddp_worker.finish(procs)
    results = [torch.load(out / f"spatial_{rank}.pt", weights_only=False)
               for rank in range(2)]
    return {"ranks": results, "jax": jax_out, "jax_empty": jax_empty}


def spawned(tmp_path_factory):
    """The spawn's results (``_spawn``), run once for every test file and
    xdist worker of the session."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        # the run's directory, which holds every worker's
        base = base.parent
    path = base / "torch_spatial_ranks.pt"
    with open(base / "torch_spatial_ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = tmp_path_factory.mktemp("torch_spatial")
            try:
                results = _spawn(out)
            finally:
                shutil.rmtree(out, ignore_errors=True)
            torch.save(results, path.with_suffix(".tmp"))
            os.replace(path.with_suffix(".tmp"), path)
    return torch.load(path, weights_only=False)


def rel_close(ours, ref, rel, what):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rel * abs(ref), (what, ours, ref)


def grad_distances(grads, ref):
    """(largest of each tensor's max |diff| over its max |ref|, relative
    L2 over the module) of a module's gradients from ``ref``."""
    worst = num = den = 0.0
    for key, grad in grads.items():
        got = grad.double().numpy()
        worst = max(worst, np.abs(got - ref[key]).max()
                    / np.abs(ref[key]).max())
        num += float(((got - ref[key]) ** 2).sum())
        den += float((ref[key] ** 2).sum())
    return worst, np.sqrt(num / den)


def check_against_jax(ours, control, jax_out):
    """A float32 step of the port (``ours``: rank 0's metrics, features,
    eval results and stats, gradients) against the JAX step, with
    ``control`` the one-process port's step on the same inputs (None: no
    control, the tolerances alone): losses
    and depth metrics JAX_REL_TOL relative, eval maps and replay features
    JAX_REL_TOL of their maximum, the semantic, panoptic and instance maps
    and ``sem_conf`` equal, a module's gradients JAX_GRAD_MAX and
    JAX_GRAD_L2 or CONTROL times the control's distance, whichever is
    larger."""
    mu, (jmetrics, jfeat, jres, jstats), jax_stats, cfg = jax_out
    for key, ref in jmetrics.items():
        rel_close(ours["metrics"][key], ref, JAX_REL_TOL, key)
    feat = ours["features"].numpy()
    assert np.abs(feat - jfeat).max() <= JAX_REL_TOL * np.abs(jfeat).max()
    pres = {k: v.numpy() for k, v in ours["results"].items()
            if v is not None}
    for key in ("depth", "semantic_soft", "center", "offset"):
        err = np.abs(pres[key] - jres[key]).max()
        assert err <= JAX_REL_TOL * np.abs(jres[key]).max(), (key, err)
    for key in ("semantic", "panoptic", "instance"):
        np.testing.assert_array_equal(pres[key], jres[key], err_msg=key)
    np.testing.assert_array_equal(ours["stats"]["sem_conf"].numpy(),
                                  jstats["sem_conf"])
    for key, ref in jstats.items():
        if key != "sem_conf":
            rel_close(ours["stats"][key], ref, JAX_REL_TOL, key)
    # Adam's first moment after one step from zero is (1 - b1) * g
    convert = {"backbone_pose_sflow": lambda p: from_jax.resnet_encoder(
        p, jax_stats["backbone_pose_sflow"], 18),
        "depth_head": from_jax.depth_head, "pose_head": from_jax.pose_head,
        "semantic_head": lambda p: from_jax.semantic_head(p, True)}
    for name in worker.LIVE:
        ref = {key: value.numpy() / (1.0 - 0.9)
               for key, value in convert[name](mu[name]).items()}
        split = grad_distances(ours["grads"][name], ref)
        control_d = (0.0, 0.0) if control is None else grad_distances(
            control["grads"][name], ref)
        assert split[0] <= max(JAX_GRAD_MAX, CONTROL * control_d[0]), \
            (name, split, control_d)
        assert split[1] <= max(JAX_GRAD_L2, CONTROL * control_d[1]), \
            (name, split, control_d)
