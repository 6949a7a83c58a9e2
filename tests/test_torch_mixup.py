"""The port's mixup pieces against ``codeps_tpu``: the host camera warp
(``c2c_prewarp``), the pair gather at its taps (``grid_sample_pair_pre``)
and the adaptation step with fused cut/class mixup.

Tolerances: the warp's taps and weights exact (the same float64 numpy on
both sides); the gathered RGB within 1e-6 (the same float32 products in
the same order), labels exact; the fused step's losses within 1e-4
relative (see test_torch_adapt.py), on the same weights, batch and
automask noise. One JAX compile serves the step's tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.ops.grid_sample import grid_sample_pair_pre as jax_pair
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_adapt_state as jax_make_adapt_state
from codeps_tpu.tasks.adapt import build_eval_forward as jax_eval_forward
from codeps_tpu.tasks.adapt import make_adapt_step as jax_make_adapt_step
from codeps_tpu.tasks.mixup_prep import c2c_prewarp as jax_c2c_prewarp

from codeps_torch.config import gen_config
from codeps_torch.io import from_jax
from codeps_torch.models import build_modules, init_params
from codeps_torch.ops.grid_sample import grid_sample_pair_pre, prewarp_host
from codeps_torch.tasks.adapt import (batch_to_device, build_eval_forward,
                                      compose_mixup, make_adapt_step)
from codeps_torch.tasks.mixup_prep import c2c_prewarp
from codeps_torch.tasks.state import make_adapt_state
from torch_parity import JaxNoise

# KITTI-360's camera 00 (1408x376) and a Cityscapes camera (2048x1024)
KITTI_360 = (552.554261, 552.554261, 682.049453, 238.769549)
CITYSCAPES = (2262.52, 2265.3017905988554, 1096.98, 513.137)
HT, WT = 32, 64
HS, WS = 32, 96
NC = 14
THINGS = (9, 10, 11, 12, 13)
FROZEN = ("backbone_po_depth", "instance_head")
EMA = ("semantic_head",)
GROUPS = (("cut_mixup", 1), ("class_mixup", 1))
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _camera(intrinsics, full, size):
    """``intrinsics`` of an image of ``full`` (W, H) scaled to ``size``
    (H, W)."""
    sx, sy = size[1] / full[0], size[0] / full[1]
    fx, fy, cx, cy = intrinsics
    return np.asarray([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)


def _warp_cases():
    """(name, sampled intrinsics (B, 4), out intrinsics (B, 4), sampled
    size, out size)."""
    rng = np.random.default_rng(0)
    tgt = _camera(KITTI_360, (1408, 376), (HT, WT))
    src = _camera(CITYSCAPES, (2048, 1024), (HS, WS))
    identity = np.asarray([[40.0, 40.0, 31.0, 15.0]], np.float32)
    # half the focal length and a doubled lattice: every other output
    # pixel lands on an exactly integer input coordinate
    half = np.asarray([[20.0, 20.0, 15.0, 7.0]], np.float32)
    random_cams = rng.uniform([20, 20, 10, 5], [80, 80, 60, 30],
                              (2, 4)).astype(np.float32)
    return [
        ("KITTI-360 -> Cityscapes", np.stack([tgt, tgt]),
         np.stack([src, src]), (HT, WT), (HS, WS)),
        ("identity, integer taps", identity, identity, (HT, WT), (HT, WT)),
        ("doubled lattice, integer taps", half, identity, (HT // 2, WT // 2),
         (HT, WT)),
        ("random cameras", random_cams, random_cams[::-1].copy(), (HT, WT),
         (HS, WS)),
    ]


CASES = _warp_cases()
IDS = [case[0] for case in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_c2c_prewarp_exact(case):
    _, sampled, out, sampled_size, out_size = case
    ref = jax_c2c_prewarp(sampled, out, sampled_size, out_size)
    ours = c2c_prewarp(sampled, out, sampled_size, out_size)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_prewarp_host_matches_at_exact_integers():
    x = np.asarray([[[0.0, 1.0, 2.0, 2.5, 3.5, -0.5, 7.0, 7.5]]])
    y = np.asarray([[[0.0, 3.0, 1.5, 2.5, 0.5, 6.0, 7.0, -1.0]]])
    from codeps_tpu.ops.grid_sample import prewarp_host as jax_prewarp_host
    ref = jax_prewarp_host(x, y, 8, 8)
    ours = prewarp_host(x, y, 8, 8)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pair_gather_matches(case):
    _, sampled, out, sampled_size, out_size = case
    rng = np.random.default_rng(1)
    batch = sampled.shape[0]
    rgb = rng.normal(0, 1, (batch, *sampled_size, 3)).astype(np.float32)
    labels = rng.integers(0, NC, (batch, *sampled_size, 1)).astype(
        np.float32)
    pre = jax_c2c_prewarp(sampled, out, sampled_size, out_size)
    ref_rgb, ref_nn = jax_pair(jnp.asarray(rgb), jnp.asarray(labels),
                               {k: jnp.asarray(v) for k, v in pre.items()})
    ours_rgb, ours_nn = grid_sample_pair_pre(
        torch.from_numpy(rgb), torch.from_numpy(labels.astype(np.int64)),
        batch_to_device(c2c_prewarp(sampled, out, sampled_size, out_size),
                        "cpu"))
    assert tuple(ours_rgb.shape) == (batch, *out_size, 3)
    np.testing.assert_allclose(ours_rgb.numpy(), np.asarray(ref_rgb),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours_nn.numpy(),
                                  np.asarray(ref_nn).astype(np.int64))


def _configure(cfg):
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.adapt.ema.semantic = True
    cfg.adapt.ema.alpha = 0.99
    cfg.losses.weights.semantic_class_mixup = 1.0
    cfg.adapt.mixup.cut_mix.nof_hor_splits = 4
    cfg.adapt.mixup.cut_mix.nof_vert_splits = 2
    cfg.adapt.mixup.cut_mix.nof_segments = 2
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _batch(seed, geom_augment=True):
    rng = np.random.default_rng(seed)
    tgt_cam = _camera(KITTI_360, (1408, 376), (HT, WT))
    src_cam = _camera(CITYSCAPES, (2048, 1024), (HS, WS))

    def frames(n, h, w):
        return rng.integers(0, 256, (n, 3, h, w, 3), dtype=np.uint8)

    src_size = (HS, WS) if geom_augment else (HT, WT)
    semantic_src = rng.integers(0, NC, (2, *src_size)).astype(np.int32)
    semantic_src[1, :, : src_size[1] // 2] = 255          # void in a label
    table = np.zeros((1, 256), bool)
    table[0, [1, 4, 9, 255]] = True
    mixup = {
        "rgb_src": rng.integers(0, 256, (2, *src_size, 3), dtype=np.uint8),
        "semantic_src": semantic_src,
        "rgb_tgt": rng.integers(0, 256, (2, HT, WT, 3), dtype=np.uint8),
        "cut_cells": np.asarray([[1, 6]], np.int32),
        "class_replace": table,
    }
    if geom_augment:
        mixup["prewarp"] = c2c_prewarp(np.stack([tgt_cam, tgt_cam]),
                                       np.stack([src_cam, src_cam]),
                                       (HT, WT), (HS, WS))
    return {
        "target": {"frames": frames(1, HT, WT), "camera": tgt_cam[None]},
        "source": {
            "frames": frames(2, HS, WS),
            "camera": np.stack([src_cam, src_cam]),
            "semantic": rng.integers(0, NC, (2, HS, WS)).astype(np.int32),
            "semantic_weights": rng.uniform(0.5, 2.0, (2, HS, WS)).astype(
                np.float32),
            "center": rng.uniform(0, 1, (2, HS, WS, 1)).astype(np.float32),
            "offset": rng.normal(0, 4, (2, HS, WS, 2)).astype(np.float32),
        },
        "target_replay": {"frames": frames(2, HT, WT),
                          "camera": np.stack([tgt_cam, tgt_cam])},
        "mixup": mixup,
        "eval_gt": {
            "semantic": rng.integers(0, NC, (1, HT, WT)).astype(np.int32),
            "depth_gt": rng.uniform(1, 60, (1, HT, WT)).astype(np.float32),
        },
    }


@pytest.fixture(scope="module")
def fused_steps():
    """One step with fused cut and class mixup on both sides."""
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False))
    jcfg.tpu.compute_dtype = "float32"
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    (HT, WT))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    tx = jax_build_optimizer(jcfg, 1e-4, frozen_modules=FROZEN)
    jstep = jax_make_adapt_step(
        jmodules, jcfg, tx, class_weights=[1.0] * NC, ema_modules=EMA,
        frozen_modules=FROZEN, has_replay=True, num_mixup=2,
        mixup_groups=GROUPS, fused_mixup=True, donate=False,
        eval_forward=jax_eval_forward(jmodules, jcfg, THINGS))
    key = jax.random.PRNGKey(2)
    state = jax_make_adapt_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx, jnp.array(key), ema_modules=EMA, frozen_modules=FROZEN,
        ema_alpha=0.99)
    batch = _batch(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    _, jmetrics, jfeatures, _, _ = jstep(state, jbatch)

    pcfg = _configure(gen_config(adapt=True, freeze=False))
    modules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg)
    pstate = make_adapt_state(modules, 1e-4, ema_modules=EMA,
                              frozen_modules=FROZEN, ema_alpha=0.99,
                              device="cpu")
    pstep = make_adapt_step(pcfg, [1.0] * NC, has_replay=True, num_mixup=2,
                            mixup_groups=GROUPS, fused_mixup=True,
                            eval_forward=build_eval_forward(pcfg, THINGS,
                                                            NC))
    pmetrics, pfeatures, _, _ = pstep(pstate, batch, noise=JaxNoise(key))
    return (jax.tree.map(np.array, jmetrics), np.array(jfeatures),
            pmetrics, pfeatures)


def test_fused_mixup_losses_match(fused_steps):
    jmetrics, _, pmetrics, _ = fused_steps
    assert set(pmetrics) == set(jmetrics)
    for key in ("semantic_cut_mixup", "semantic_class_mixup",
                "semantic_source", "loss_total"):
        assert key in jmetrics, key
    for key, ref in jmetrics.items():
        if key == "target_skipped":
            assert bool(pmetrics[key]) is bool(ref) is False
            continue
        ours = float(pmetrics[key])
        assert abs(ours - float(ref)) <= REL_TOL * abs(float(ref)), (
            key, ours, float(ref))


def test_fused_mixup_features_match(fused_steps):
    _, jfeatures, _, pfeatures = fused_steps
    err = np.abs(pfeatures.numpy() - jfeatures).max()
    assert err <= REL_TOL * np.abs(jfeatures).max(), err


def _port_teacher(cfg):
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=5,
                          device="cpu")
    return make_adapt_state(modules, 1e-4, ema_modules=EMA,
                            frozen_modules=FROZEN, device="cpu").teacher


def test_fused_mixup_without_the_camera_warp():
    """Without ``geom_augment`` the target frames are composed as they are
    (equal feed sizes): the step runs and its mixup losses are finite."""
    cfg = _configure(gen_config(adapt=True, freeze=False))
    cfg.adapt.mixup.general.geom_augment = False
    modules = init_params(build_modules(cfg, NC, device="cpu"), seed=5,
                          device="cpu")
    state = make_adapt_state(modules, 1e-4, ema_modules=EMA,
                             frozen_modules=FROZEN, device="cpu")
    step = make_adapt_step(cfg, [1.0] * NC, has_replay=True, num_mixup=2,
                           mixup_groups=GROUPS, fused_mixup=True)
    metrics, _ = step(state, _batch(4, geom_augment=False))
    for key in ("semantic_cut_mixup", "semantic_class_mixup"):
        assert bool(torch.isfinite(metrics[key])), key


def test_cut_and_class_masks():
    """The composition's masks: cut cells end one pixel short of the next
    cell (the seam), class mixup takes exactly the source pixels whose
    class the table marks (void included when marked), and the labels
    follow the image."""
    cfg = _configure(gen_config(adapt=True, freeze=False))
    mixup = batch_to_device(_batch(6)["mixup"], "cpu")
    mixup["rgb_src"] = torch.zeros_like(mixup["rgb_src"])
    rgb, semantic = compose_mixup(
        _port_teacher(cfg), mixup, GROUPS, cfg.adapt.mixup.cut_mix, True,
        cfg.dataset.normalization.rgb_mean, cfg.dataset.normalization.rgb_std)
    mean = torch.tensor(cfg.dataset.normalization.rgb_mean)
    std = torch.tensor(cfg.dataset.normalization.rgb_std)
    black = -mean / std
    from_source = (rgb == black).all(dim=-1)
    # cut: cells 1 and 6 of the 2x4 grid over 32x96 (16 x 24 pixels each,
    # less the last row and column)
    expect_cut = torch.zeros(HS, WS, dtype=torch.bool)
    for cell in (1, 6):
        y, x = divmod(cell, 4)
        expect_cut[y * 16:(y + 1) * 16 - 1, x * 24:(x + 1) * 24 - 1] = True
    assert torch.equal(~from_source[0], expect_cut)
    # class: classes 1, 4, 9 and void come from the target
    sem = mixup["semantic_src"][1]
    marked = (sem == 1) | (sem == 4) | (sem == 9) | (sem == 255)
    assert torch.equal(~from_source[1], marked)
    kept = torch.stack([~expect_cut, ~marked])
    assert torch.equal(semantic[kept], mixup["semantic_src"][kept])
    assert semantic.dtype == torch.int32


def test_gt_panoptic_step_matches(tmp_path):
    """The GT panoptic map of a KITTI-360 frame (integer labels, GT
    centers and offsets) equals the JAX step's, with the offsets passed as
    the runner passes them: the NHWC view of (2, H, W) planes."""
    from codeps_tpu.tasks.adapt import (
        make_gt_panoptic_step as jax_gt_panoptic_step)
    from codeps_torch.data.kitti_360 import Kitti360
    from codeps_torch.data.synthetic import make_kitti360_tree
    from codeps_torch.tasks.adapt import make_gt_panoptic_step

    cfg = gen_config(adapt=True, freeze=False)
    cfg.dataset.name = "kitti_360"
    cfg.dataset.path = str(make_kitti360_tree(tmp_path / "k360",
                                              num_frames=3))
    cfg.dataset.feed_img_size = [48, 96]
    cfg.dataset.center_heatmap_sigma = 4
    # keep the synthetic tree's small instances in the evaluation labels
    cfg.dataset.small_instance_area_full_res = 100
    reader = Kitti360("sequence", cfg.dataset, sequences=["03"])
    samples = [reader.__getitem__(i, do_augmentation=False,
                                  do_network_preparation=False)
               for i in range(2)]
    semantic = np.stack([s["semantic_eval"] for s in samples]).astype(
        np.int32)
    center = np.stack([s["center"] for s in samples])
    offset = np.stack([s["offset"] for s in samples])
    ref = jax_gt_panoptic_step(jax_build_modules(
        _configure(jax_gen_config(adapt=True, freeze=False)), NC), THINGS)(
            jnp.asarray(semantic), jnp.asarray(center), jnp.asarray(offset))
    planes = torch.from_numpy(np.ascontiguousarray(
        offset.transpose(0, 3, 1, 2)))
    ours = make_gt_panoptic_step(THINGS, NC)(
        torch.from_numpy(semantic), torch.from_numpy(center),
        planes.permute(0, 2, 3, 1))
    assert (np.asarray(ref) >= 9000).any()          # things were grouped
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
