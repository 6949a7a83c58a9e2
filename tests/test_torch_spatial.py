"""Spatial (row) sharding of the adaptation step over processes
(``codeps_torch/parallel/spatial.py``, the counterpart of
``codeps_tpu/parallel/spatial.py``), on the CPU over gloo.

One spawn of 2 ranks (``tests/_spatial_worker.py``, one intra-op thread
each) serves the module: each check runs on the ranks' rows inside
``spatial.rows()`` and is held against the same port code in one process
(``parallel.replicated()``), or against the JAX package's step:

  - ``halo_rows`` (zeros, reflect, replicate and -inf edges, halos of 0-3
    rows) and ``gather_rows`` against the padding and concatenation of
    the whole tensor, forward and backward (each rank's loss weighs its
    own output), float64, on even slabs and on the uneven slabs of 96
    rows (2 + 1 blocks) at strides 32 and 16, where a reflection at the
    image's edge reaches into the neighbour's rows: outputs equal,
    gradients within 1e-12 relative;
  - each ported module and loss at 64x96 in float64 (ResNet-18 and
    ResNet-50 in eval and train mode, the depth, semantic (GUDA and
    reflect-padded) and instance heads, the bilinear and nearest resizes,
    the warp, the reconstruction, smoothness, top-k semantic and instance
    losses): outputs (gathered, or the ranks' shares summed) and
    gradients within 1e-10 relative of one process (measured at most
    1.4e-11, the instance head's train-mode BatchNorm at 2x3 pixels);
  - the resizes and the warp also on the uneven slabs of 96 rows;
  - the whole adaptation step in float64, 2 steps with the published
    freezing and the fused cut mixup (the teacher's labels gathered before
    the camera warp), 1 step with a live depth encoder, 1 published step
    at 96 rows (2 + 1 blocks), 1 step with the scene-flow head and a live
    depth encoder (its motion pair in the eval results): losses and every
    live module's gradient within 1e-10 relative, parameters after the
    steps within 1e-12, replay features, ``sem_conf`` and the fused
    panoptic map equal; rank 0 alone scores the teacher eval;
  - the step in float32 against the JAX package's ``make_adapt_step`` on
    the same weights, batch and automask noise, with
    ``tests/test_torch_adapt.py``'s tolerances (losses and depth metrics
    1e-4 relative, eval maps and replay features 1e-4 of their maximum,
    the semantic, panoptic and instance maps and ``sem_conf`` equal;
    gradients 2e-4 of each tensor's maximum and 1e-4 relative L2 a
    module) or, for a module's gradients, 1.5 times the distance of the
    one-process port's step from JAX on the same inputs, whichever is
    larger. At 64x96, the least height that splits over 2 ranks, the pose
    net's train-mode BatchNorm normalizes 24 values a channel in layer4
    and amplifies float32 rounding: the one-process port's gradients lie
    1.1e-2 (pose net), 2.3e-4 (pose head) and 1.1e-4 (depth head) from
    JAX's by relative L2, past those tolerances, which
    ``tests/test_torch_adapt.py`` meets at 32x64 (the semantic head's:
    5.7e-7);
  - ``AdaptationRunner`` with ``tpu.spatial_shard`` streaming the
    synthetic KITTI-360 tree for 3 frames on 2 ranks against one process:
    equal buffer ids and step counts, PQ, mIoU and abs_rel within
    ``scripts/parity_e2e.py:52-54``'s tolerances, losses within 1e-5
    relative (float32 sums of the ranks' shares);
  - heights that are not whole 32-row blocks, or fewer blocks than
    ranks, raise; 96 rows do not, and the flow head streams 2 frames.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
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
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)
from codeps_torch.io import from_jax
from codeps_torch.parallel import spatial

MODULE_TOL = 1e-10
HALO_GRAD_TOL = 1e-12
PARAM_TOL = 1e-12
JAX_REL_TOL = 1e-4
JAX_GRAD_MAX = 2e-4
JAX_GRAD_L2 = 1e-4
# the row split's gradient distance from JAX, as a multiple of the
# one-process port's own (see the docstring)
CONTROL = 1.5
RUNNER_LOSS_REL = 1e-5
PQ_TOL = MIOU_TOL = ABS_REL_TOL = 0.005
NUM_SCALES = 5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_noise(step_key):
    """The automask normals one JAX step draws, in the order the port asks
    for them (source scales, then the target and replay's), NCHW."""
    def scales(key, batch):
        out = []
        for s in range(NUM_SCALES):
            key, sub = jax.random.split(key)
            draw = jax.random.normal(
                sub, (batch, worker.H >> s, worker.W >> s, 2), jnp.float32)
            out.append(np.asarray(draw).transpose(0, 3, 1, 2))
        return out
    _, loss_key = jax.random.split(step_key)
    key, sub = jax.random.split(loss_key)
    source = scales(sub, worker.NUM_SOURCE)
    _, sub = jax.random.split(key)
    return source + scales(sub, 1 + worker.NUM_REPLAY)


def _jax_step(out_dir):
    """The JAX step on a uint8 batch of ``worker.step_batch``: writes the
    port's inputs (state dicts, batch, noise) for the ranks and returns
    the JAX outputs and the weights."""
    jcfg = jax_gen_config(adapt=True, freeze=False)
    jcfg.model.po_depth_net.params.nof_layers = 18
    jcfg.model.pose_sflow_net.params.nof_layers = 18
    jcfg.semantics.class_weights = [1.0] * worker.NC
    jcfg.adapt.ema.semantic = True
    jcfg.adapt.ema.alpha = 0.99
    jcfg.tpu.compute_dtype = "float32"
    jmodules = jax_build_modules(jcfg, num_classes=worker.NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    (worker.H, worker.W))
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
    batch = worker.step_batch(50, np.uint8)
    noise = _jax_noise(state.rng)
    state, *results = step(state, jax.tree.map(jnp.asarray, batch))
    cfg = worker.step_config()
    partial = out_dir / "jax_inputs.tmp"
    torch.save({"state_dicts": from_jax.state_dicts_from_jax(params, stats,
                                                             cfg),
                "batch": batch, "noise": noise}, partial)
    os.replace(partial, out_dir / "jax_inputs.pt")
    return (jax.tree.map(np.array, state), jax.tree.map(np.array, results),
            stats, cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every check's results on each of the 2 ranks, and the JAX step's
    outputs."""
    out = tmp_path_factory.mktemp("torch_spatial")
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
        # the ranks run their other checks while JAX compiles its step
        jax_out = _jax_step(out)
    finally:
        _ddp_worker.finish(procs)
    results = [torch.load(out / f"spatial_{rank}.pt", weights_only=False)
               for rank in range(2)]
    shutil.rmtree(out, ignore_errors=True)
    return {"ranks": results, "jax": jax_out}


def test_halo_and_gather_rows(ranks):
    for result in ranks["ranks"]:
        assert len(result["halo"]) == sum(len(cases) + 1 for _, _, cases
                                          in worker.HALO_SIZES)
        for name, case in result["halo"].items():
            assert case["out"] == 0.0, (name, case)
            assert case.get("inf_equal", True), name
            assert case["grad"] <= HALO_GRAD_TOL, (name, case)


def _module_distances(ranks, prefixes):
    found = 0
    for result in ranks["ranks"]:
        for name, distances in result["modules"].items():
            if name.startswith(prefixes):
                found += 1
                for key, value in distances.items():
                    assert value <= MODULE_TOL, (name, key, value)
    return found


def test_encoders_match_one_process(ranks):
    assert _module_distances(ranks, ("encoder",)) == 2 * 4


def test_heads_match_one_process(ranks):
    assert _module_distances(ranks, ("depth head", "semantic head",
                                     "instance head")) == 2 * 4


def test_resizes_and_warp_match_one_process(ranks):
    # at 64 rows (32 + 32) and at 96 (64 + 32)
    assert _module_distances(ranks, ("resize", "warp")) == 2 * 2 * 6


def test_losses_match_one_process(ranks):
    assert _module_distances(ranks, ("reconstruction", "smoothness",
                                     "semantic loss", "instance loss")) \
        == 2 * 4


@pytest.mark.parametrize("variant", [v[0] for v in worker.STEP_VARIANTS])
def test_step_float64_matches_one_process(ranks, variant):
    lead, follower = (r["step"][variant] for r in ranks["ranks"])
    # every rank holds the global metrics; rank 0 alone scores the eval
    assert lead["metrics"] == follower["metrics"]
    assert not any(lead["eval_on_followers"])
    assert all(follower["eval_on_followers"])
    assert lead["loss_rel"] <= MODULE_TOL, lead["loss_rel"]
    assert set(lead["grad_rel_l2"]) >= {"backbone_pose_sflow", "depth_head",
                                        "pose_head", "semantic_head"}
    for name, value in lead["grad_rel_l2"].items():
        assert value <= MODULE_TOL, (name, value)
    assert lead["param_diff"] <= PARAM_TOL, lead["param_diff"]
    assert lead["features"] == 0.0
    assert lead["eval_maps"] <= MODULE_TOL
    assert lead["checks"] == len(lead["metrics"])
    assert lead["sem_conf_equal"] and lead["panoptic_equal"]


def _rel_close(ours, ref, rel, what):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rel * abs(ref), (what, ours, ref)


def test_step_float32_matches_jax(ranks):
    jstate, (jmetrics, jfeat, jres, jstats), jax_stats, cfg = ranks["jax"]
    ours = ranks["ranks"][0]["jax"]
    assert ranks["ranks"][1]["jax"]["metrics"] == ours["metrics"]
    for key, ref in jmetrics.items():
        _rel_close(ours["metrics"][key], ref, JAX_REL_TOL, key)
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
            _rel_close(ours["stats"][key], ref, JAX_REL_TOL, key)
    # Adam's first moment after one step from zero is (1 - b1) * g
    mu = jstate.opt_state.inner_states["trained"].inner_state[0].mu
    convert = {"backbone_pose_sflow": lambda p: from_jax.resnet_encoder(
        p, jax_stats["backbone_pose_sflow"], 18),
        "depth_head": from_jax.depth_head, "pose_head": from_jax.pose_head,
        "semantic_head": lambda p: from_jax.semantic_head(p, True)}
    for name in worker.LIVE:
        ref = {key: value.numpy() / (1.0 - 0.9)
               for key, value in convert[name](mu[name]).items()}
        split = _grad_distances(ours["grads"][name], ref)
        control = _grad_distances(ours["one_process"]["grads"][name], ref)
        assert split[0] <= max(JAX_GRAD_MAX, CONTROL * control[0]), \
            (name, split, control)
        assert split[1] <= max(JAX_GRAD_L2, CONTROL * control[1]), \
            (name, split, control)


def _grad_distances(grads, ref):
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


def test_runner_matches_one_process(ranks):
    lead = ranks["ranks"][0]["runner"]
    ours, ref = lead["spatial"], lead["one_process"]
    assert ours["ids"] == ref["ids"]
    assert ours["steps"] == ref["steps"] == worker.RUNNER_FRAMES
    # a broadcast a frame, then the stop message
    assert len(ours["row_times"]["broadcast"]) == worker.RUNNER_FRAMES + 1
    follower = ranks["ranks"][1]["runner"]["spatial"]
    assert len(follower["row_times"]["step"]) == worker.RUNNER_FRAMES
    assert follower["steps"] == 0
    values, expect = ours["values"], ref["values"]
    for key, tol in (("metrics.p_pq", PQ_TOL), ("metrics.sem_miou",
                                                 MIOU_TOL),
                     ("metrics.d_abs_rel", ABS_REL_TOL)):
        assert abs(values[key] - expect[key]) <= tol, key
    for key, value in expect.items():
        if key.startswith("losses."):
            assert abs(values[key] - value) <= RUNNER_LOSS_REL * abs(
                value), key


def test_raises(ranks):
    for result in ranks["ranks"]:
        raises = result["raises"]
        # not a multiple of 32 rows, and fewer blocks than ranks
        assert "80 rows does not split over 2 ranks" in raises[80]
        assert "32 rows does not split over 2 ranks" in raises[32]
        # 2 + 1 blocks, and the flow head's stream
        assert raises[worker.UNEVEN_H] == "no error"
        assert raises["flow"] == "no error"
    assert ranks["ranks"][0]["raises"]["flow_steps"] == 2


def test_rows_without_a_group_change_nothing():
    """Outside a process group ``spatial.rows()`` is inactive: the step
    inside it computes bit for bit what it computes outside."""
    cfg = worker.step_config()
    batch = worker.step_batch(60, np.uint8)
    runs = []
    for split in (False, True):
        modules, step = worker.build_step(cfg)
        if split:
            with spatial.rows():
                assert not spatial.active()
                runs.append(worker.run_steps(modules, step, [batch]))
        else:
            runs.append(worker.run_steps(modules, step, [batch]))
    (plain, plain_sds), (rows, rows_sds) = runs
    assert plain[0]["metrics"] == rows[0]["metrics"]
    for name, grads in plain[0]["grads"].items():
        for key, grad in grads.items():
            assert torch.equal(rows[0]["grads"][name][key], grad), key
    assert torch.equal(plain[0]["results"]["panoptic"],
                       rows[0]["results"]["panoptic"])
