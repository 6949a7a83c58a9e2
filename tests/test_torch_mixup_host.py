"""The port's host mixup path against ``codeps_tpu``, function by function:
kornia's one-row distance transform and the Manhattan transform, the three
``Mixup`` strategies, ``do_mixup``, the camera-to-camera warp
(``warp_c2c``, ``c2c_grid``), the plain sampling pair
(``grid_sample_pair``) and the teacher's pseudo-label steps
(``make_plabel_step``, ``make_plabel_prep_step``).

Tolerances: the numpy functions and every label map exact; composed RGB
exact (the same float32 copies); sampled RGB within 1e-6 for
``grid_sample_pair`` (float32 products in another order) and within 1e-5
through ``warp_c2c`` (the float32 grid's rounding carried through the
interpolation); nearest samples exact, and a flipped pixel is named in
the failure. The pseudo-label steps run ResNet-18 at 32x64 in float32 from
the same JAX-made weights (one JAX compile each, shared through a module
fixture): labels and warped maps exact, center and offset within 1e-4 and
warped RGB within 1e-5. Those weights have the thing logits and the center
head's output raised so that the pseudo-labels hold instances.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.data import mixup as jax_mixup
from codeps_tpu.data.dataset import get_offset_center
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.ops.grid_sample import grid_sample_pair as jax_pair
from codeps_tpu.tasks.adapt import make_plabel_step as jax_plabel_step
from codeps_tpu.tasks.mixup_prep import c2c_grid as jax_c2c_grid
from codeps_tpu.tasks.mixup_prep import \
    make_plabel_prep_step as jax_plabel_prep

from codeps_torch.config import gen_config
from codeps_torch.data import mixup
from codeps_torch.io import from_jax
from codeps_torch.models import build_modules
from codeps_torch.ops.grid_sample import grid_sample_pair
from codeps_torch.tasks.adapt import batch_to_device, make_plabel_step
from codeps_torch.tasks.mixup_prep import (c2c_grid, c2c_prewarp,
                                           make_plabel_prep_step)
from torch_parity import raise_instances

# KITTI-360's camera 00 (1408x376) and a Cityscapes camera (2048x1024)
KITTI_360 = (552.554261, 552.554261, 682.049453, 238.769549)
CITYSCAPES = (2262.52, 2265.3017905988554, 1096.98, 513.137)
NC = 14
THINGS = (9, 10, 11, 12, 13)
HT, WT = 32, 64          # target frames
HS, WS = 32, 96          # source frames (the pseudo-label steps)
H, W = 48, 80            # composition


def _camera(intrinsics, full, size):
    """``intrinsics`` of an image of ``full`` (W, H) scaled to ``size``
    (H, W)."""
    sx, sy = size[1] / full[0], size[0] / full[1]
    fx, fy, cx, cy = intrinsics
    return np.asarray([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)


def _masks():
    rng = np.random.default_rng(0)
    empty = np.zeros((24, 40), np.uint8)
    sparse = (rng.random((24, 40)) < 0.02).astype(np.uint8)
    dense = (rng.random((24, 40)) < 0.4).astype(np.uint8)
    block = empty.copy()
    block[5:12, 30:38] = 1
    corner = empty.copy()
    corner[0, 0] = 1
    return {"empty": empty, "sparse": sparse, "dense": dense,
            "block": block, "corner": corner}


MASKS = _masks()


def test_distance_transforms_exact():
    for name, mask in MASKS.items():
        for row in (0, 7, mask.shape[0] - 1):
            ref = jax_mixup.kornia_dist_row(mask, row)
            ours = mixup.kornia_dist_row(mask, row)
            assert ours.dtype == ref.dtype == np.float64
            np.testing.assert_array_equal(ours, ref,
                                          err_msg=f"{name} row {row}")
        ref = jax_mixup.distance_transform_manhattan(mask)
        ours = mixup.distance_transform_manhattan(mask)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def _scene(seed):
    """Source and target of one composition at H x W: RGB, semantic and
    instance maps. The source's things stand on the left; the target's
    instances are rectangles wider than half the frame sharing ten rows,
    laid over each other, so that any two pasted instances overlap; one of
    them carries a stuff class (a thing list drops it)."""
    rng = np.random.default_rng(seed)
    semantic_src = rng.integers(0, 9, (H, W)).astype(np.int32)
    instance_src = np.zeros((H, W), np.int32)
    for i in range(2):
        y, x = 10 + 14 * i, 2 + 6 * i
        semantic_src[y:y + 12, x:x + 8] = THINGS[i]
        instance_src[y:y + 12, x:x + 8] = THINGS[i] * 1000 + i + 1
    semantic_tgt = rng.integers(0, 9, (H, W)).astype(np.int32)
    instance_tgt = np.zeros((H, W), np.int32)
    for i in range(4):
        # every instance covers rows 14-23 and more than half the width
        h = int(rng.integers(16, 22))
        w = int(rng.integers(W // 2 + 2, W - 8))
        y = int(rng.integers(4, 15))
        x = int(rng.integers(0, W - w))
        instance_tgt[y:y + h, x:x + w] = i + 1
        semantic_tgt[y:y + h, x:x + w] = 3 if i == 2 else THINGS[i]
    return {"img_src": rng.normal(0, 1, (H, W, 3)).astype(np.float32),
            "img_tgt": rng.normal(0, 1, (H, W, 3)).astype(np.float32),
            "instance_src": instance_src, "semantic_src": semantic_src,
            "semantic_pred_tgt": semantic_tgt,
            "instance_pred_tgt": instance_tgt}


def _assert_equal_outputs(ours, ref, case):
    for name, a, b in zip(("rgb", "semantic", "instance"), ours, ref):
        assert a.dtype == np.asarray(b).dtype, (case, name)
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{case}: {name}")


def test_cut_and_class_mixup_exact():
    for seed in (1, 2):
        scene = _scene(seed)
        args = [scene[k] for k in ("img_src", "img_tgt", "instance_src",
                                   "semantic_src", "semantic_pred_tgt",
                                   "instance_pred_tgt")]
        for splits in ((2, 4, 2), (3, 5, 4)):
            ref = jax_mixup.Mixup.cut_mixup(np.random.default_rng(seed),
                                            *args, *splits)
            ours = mixup.Mixup.cut_mixup(np.random.default_rng(seed), *args,
                                         *splits)
            _assert_equal_outputs(ours, ref, f"cut {seed} {splits}")
        ref = jax_mixup.Mixup.class_mixup(np.random.default_rng(seed), *args)
        ours = mixup.Mixup.class_mixup(np.random.default_rng(seed), *args)
        _assert_equal_outputs(ours, ref, f"class {seed}")


@pytest.mark.parametrize("things", [None, THINGS], ids=["warped", "refused"])
def test_conf_instance_mixup_exact(things):
    """At conf_thresh 0.0 and 0.98 and min_inst_size 0 and 300."""
    scene = _scene(8)
    args = [scene[k] for k in ("img_src", "img_tgt", "instance_src",
                               "semantic_src", "semantic_pred_tgt",
                               "instance_pred_tgt")]
    for conf_thresh in (0.0, 0.98):
        for min_inst_size in (0, 300):
            case = f"conf_thresh {conf_thresh}, min_inst_size {min_inst_size}"
            ref = jax_mixup.Mixup.conf_instance_mixup(
                *args, min_inst_size, thing_list=things, num_classes=NC,
                conf_thresh=conf_thresh)
            stats = {}
            ours = mixup.Mixup.conf_instance_mixup(
                *args, min_inst_size, thing_list=things, num_classes=NC,
                conf_thresh=conf_thresh, device="cpu", stats=stats)
            _assert_equal_outputs(ours, ref, case)
            # instances were pasted over each other: the crop of the
            # earlier one ran
            assert stats["pasted"] >= 2 and stats["conflicts"] >= 1, (
                case, stats)
            pasted_ids = np.unique(ours[2][ours[2] != scene["instance_src"]])
            if things is not None:
                # the stuff-labelled rectangle is no thing after the
                # re-fusion
                assert stats["pasted"] <= 3, (case, stats)
            assert len(pasted_ids) >= 2, (case, pasted_ids)


def test_refusion_numbers_ids_in_raster_order():
    """Every instance's center is a peak of exactly 1.0: at conf_thresh
    0.98 the re-fused ids follow the raster order of the peaks (an
    instance the thing mask drops keeps its id unused)."""
    scene = _scene(4)
    instance = scene["instance_pred_tgt"]
    refused = mixup.refuse_instances(instance, scene["semantic_pred_tgt"],
                                     THINGS, NC, 0.98, "cpu")
    peaks, new_ids = [], []
    for old in np.unique(instance[refused > 0]):
        pixels = np.argwhere(instance == old)
        y, x = np.round(pixels.mean(0)).astype(int)
        peaks.append(y * W + x)
        ids, counts = np.unique(refused[instance == old],
                                return_counts=True)
        new_ids.append(int(ids[np.argmax(counts)]))
    ordered = [new_ids[i] for i in np.argsort(peaks)]
    assert len(new_ids) >= 2, new_ids
    assert ordered == sorted(set(ordered)), ordered


def _mixup_cfg(geom_augment):
    return types.SimpleNamespace(
        general=types.SimpleNamespace(geom_augment=geom_augment),
        cut_mix=types.SimpleNamespace(nof_vert_splits=2, nof_hor_splits=4,
                                      nof_segments=2),
        conf_instance_mix=types.SimpleNamespace(conf_thresh=0.98,
                                                min_inst_size=10))


def _mixup_data(seed, geom_augment):
    """do_mixup's materials: the teacher's predictions are the exact
    center and offsets of a target instance map, the offsets with a little
    noise."""
    rng = np.random.default_rng(seed)
    scene = _scene(seed)
    tgt_size = (HT, WT) if geom_augment else (H, W)
    semantic = scene["semantic_pred_tgt"][:tgt_size[0], :tgt_size[1]]
    instance = scene["instance_pred_tgt"][:tgt_size[0], :tgt_size[1]]
    offset, center = get_offset_center(instance, sigma=4)
    offset = offset + rng.normal(0, 0.3, offset.shape).astype(np.float32)
    return {
        "rgb_src": {0: scene["img_src"]},
        "rgb_tgt": {0: rng.normal(0, 1, (*tgt_size, 3)).astype(np.float32)},
        "semantic_src": scene["semantic_src"],
        "instance_src": scene["instance_src"],
        "camera_model_src": _camera(CITYSCAPES, (2048, 1024), (H, W)),
        "camera_model_tgt": _camera(KITTI_360, (1408, 376), tgt_size),
        "semantic_pred_tgt_ema": semantic,
        "center_pred_tgt_ema": center,
        "offset_pred_tgt_ema": offset,
    }


def test_do_mixup_exact():
    """All three strategies, with and without the camera warp."""
    for geom_augment in (False, True):
        data = _mixup_data(5, geom_augment)
        cfg = _mixup_cfg(geom_augment)
        for strategy in ("cut_mixup", "class_mixup", "conf_instance_mixup"):
            case = f"{strategy}, geom_augment {geom_augment}"
            ref = jax_mixup.Mixup.do_mixup(strategy, data, THINGS, cfg,
                                           rng=np.random.default_rng(6),
                                           num_classes=NC)
            ours = mixup.Mixup.do_mixup(strategy, data, THINGS, cfg,
                                        rng=np.random.default_rng(6),
                                        num_classes=NC, device="cpu")
            assert set(ours) == set(ref), case
            if geom_augment:
                # the warped target RGB goes through a float32 grid
                np.testing.assert_allclose(ours["rgb"][0], ref["rgb"][0],
                                           rtol=0, atol=1e-5, err_msg=case)
            else:
                np.testing.assert_array_equal(ours["rgb"][0], ref["rgb"][0],
                                              err_msg=case)
            for key in ("semantic", "instance", "center", "offset"):
                np.testing.assert_array_equal(ours[key], ref[key],
                                              err_msg=f"{case}: {key}")
            assert (ours["instance"] != data["instance_src"]).any(), case


def _flips(ours, ref):
    bad = np.argwhere(ours != ref)
    return [(tuple(int(i) for i in p), ours[tuple(p)], ref[tuple(p)])
            for p in bad[:10]]


def test_warp_c2c_matches():
    """Both modes and both paddings, both ways between two cameras."""
    rng = np.random.default_rng(7)
    intr_src = _camera(CITYSCAPES, (2048, 1024), (HS, WS))
    intr_tgt = _camera(KITTI_360, (1408, 376), (HT, WT))
    for mode in ("bilinear", "nearest"):
        image = (rng.normal(0, 1, (HT, WT, 3)).astype(np.float32)
                 if mode == "bilinear"
                 else rng.integers(0, 40, (HT, WT)).astype(np.float32))
        for padding in ("zeros", "border"):
            for a, b, out_shape in ((intr_tgt, intr_src, (HS, WS)),
                                    (intr_src, intr_tgt, (HT + 8, WT - 8))):
                case = f"{mode}, {padding}, out {out_shape}"
                ref = np.asarray(jax_mixup.warp_c2c(
                    a, b, image, out_shape, interp_mode=mode,
                    padding_mode=padding))
                ours = mixup.warp_c2c(a, b, image, out_shape,
                                      interp_mode=mode, padding_mode=padding,
                                      device="cpu")
                assert ours.shape == ref.shape, case
                if mode == "bilinear":
                    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5,
                                               err_msg=case)
                else:
                    assert np.array_equal(ours, ref), (
                        f"{case}: nearest pixels flipped (pixel, ours, "
                        f"JAX): {_flips(ours, ref)}")


def test_grid_sample_pair_matches():
    rng = np.random.default_rng(8)
    img_lin = rng.normal(0, 1, (2, 12, 20, 3)).astype(np.float32)
    img_nn = rng.integers(0, 30, (2, 12, 20, 2)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 9, 15, 2)).astype(np.float32)
    # exactly the pixel centers of the first row and column
    grid[0, 0, :, 0] = np.linspace(-1, 1, 15, dtype=np.float32)
    grid[0, :, 0, 1] = np.linspace(-1, 1, 9, dtype=np.float32)
    ref_lin, ref_nn = jax_pair(jnp.asarray(img_lin), jnp.asarray(img_nn),
                               jnp.asarray(grid))
    ours_lin, ours_nn = grid_sample_pair(torch.from_numpy(img_lin),
                                         torch.from_numpy(img_nn),
                                         torch.from_numpy(grid))
    assert tuple(ours_lin.shape) == (2, 9, 15, 3)
    np.testing.assert_allclose(ours_lin.numpy(), np.asarray(ref_lin),
                               rtol=0, atol=1e-6)
    ref_nn = np.asarray(ref_nn)
    assert np.array_equal(ours_nn.numpy(), ref_nn), _flips(ours_nn.numpy(),
                                                           ref_nn)


def test_c2c_grid_matches():
    intr_src = np.stack([_camera(CITYSCAPES, (2048, 1024), (HS, WS))] * 2)
    intr_tgt = np.stack([_camera(KITTI_360, (1408, 376), (HT, WT)),
                         _camera(KITTI_360, (1408, 376), (HT + 4, WT))])
    ref = np.asarray(jax_c2c_grid(jnp.asarray(intr_src),
                                  jnp.asarray(intr_tgt), (HS, WS), (HT, WT)))
    ours = c2c_grid(torch.from_numpy(intr_src), torch.from_numpy(intr_tgt),
                    (HS, WS), (HT, WT))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    # float32 arithmetic of values of order 1
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


def _configure(cfg):
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.tpu.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def plabels():
    """Both packages' pseudo-label steps on the same weights and frames."""
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False))
    jmodules = jax_build_modules(jcfg, NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    (HT, WT))
    params = raise_instances(params, THINGS)
    stats = jax.tree.map(np.array, stats)
    mean = tuple(jcfg.dataset.normalization.rgb_mean)
    std = tuple(jcfg.dataset.normalization.rgb_std)
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (2, HT, WT, 3), dtype=np.uint8)
    intr_tgt = np.stack([_camera(KITTI_360, (1408, 376), (HT, WT))] * 2)
    intr_src = np.stack([_camera(CITYSCAPES, (2048, 1024), (HS, WS))] * 2)
    warp = c2c_prewarp(intr_tgt, intr_src, (HT, WT), (HS, WS))

    jparams = jax.tree.map(jnp.asarray, params)
    jstats = jax.tree.map(jnp.asarray, stats)
    ref_step = jax_plabel_step(jmodules, mean, std)(jparams, jstats,
                                                    jnp.asarray(rgb))
    ref_prep = jax_plabel_prep(jmodules, THINGS, (HS, WS), mean=mean,
                               std=std)(jparams, jstats, jnp.asarray(rgb),
                                        jax.tree.map(jnp.asarray, warp))

    pcfg = _configure(gen_config(adapt=True, freeze=False))
    teacher = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg).eval()
    ours_step = make_plabel_step(mean, std)(teacher, torch.from_numpy(rgb))
    ours_prep = make_plabel_prep_step(THINGS, NC, mean, std)(
        teacher, torch.from_numpy(rgb), batch_to_device(warp, "cpu"))
    return ([np.asarray(x) for x in ref_step], [x.numpy() for x in ours_step],
            [np.asarray(x) for x in ref_prep], [x.numpy() for x in ours_prep])


def test_plabel_step_matches(plabels):
    ref, ours, _, _ = plabels
    for name, a, b in zip(("semantic", "center", "offset"), ours, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    np.testing.assert_array_equal(ours[0], ref[0])
    assert set(np.unique(ref[0])) & set(THINGS)
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-4)


def test_plabel_prep_step_matches(plabels):
    _, _, ref, ours = plabels
    assert ours[0].shape == ref[0].shape == (2, HS, WS, 3)
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=1e-5)
    for name, a, b in zip(("semantic", "instance"), ours[1:], ref[1:]):
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the pseudo-labels hold instances, some zeroed outside the target
    assert all(len(np.unique(inst)) > 2 for inst in ref[2])
