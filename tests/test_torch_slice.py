"""The whole serving slice: the port's ``CodepsNet`` eval against the JAX
facade on the same weights and frames.

ResNet-50 (the same bottleneck code as the published ResNet-101), GUDA
semantic head, instance head, 14 classes, 64x128, two uint8 frames. The
weights are the JAX ``init_params``, carried over with
``codeps_torch.io.from_jax``. The center conv's bias is raised on both
sides so that the random weights give centers to group.

Tolerances: head outputs within 1e-4 * max|ref| (oneDNN and XLA sum the
convolutions in different orders; see test_torch_models.py). Fusion is
exact on identical head outputs. End to end, the maps agree on every
pixel whose decision is not within float error of a tie: top-2 class
probability margin above twice the semantic tolerance, and nearest-center
margin above what the offset tolerance can move.
"""

import numpy as np
import pytest
import torch

import jax

from codeps_tpu.config import get_cfg_defaults_adapt as jax_cfg_defaults
from codeps_tpu.models import CodepsNet as JaxCodepsNet
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params

from codeps_torch.config import get_cfg_defaults_adapt
from codeps_torch.io.from_jax import load_from_jax
from codeps_torch.models import CodepsNet, build_modules
from codeps_torch.ops.panoptic import panoptic_fusion_batch

HEIGHT, WIDTH = 64, 128
NUM_CLASSES = 14
THINGS = (9, 10, 11, 12, 13)
REL_TOL = 1e-4
CENTER_BIAS = 0.12


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(defaults):
    cfg = defaults()
    cfg.model.po_depth_net.params.nof_layers = 50
    cfg.dataset.feed_img_size = [HEIGHT, WIDTH]
    cfg.tpu.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def outputs():
    """(JAX eval outputs, port eval outputs) as numpy dicts."""
    cfg = _cfg(jax_cfg_defaults)
    modules = jax_build_modules(cfg, NUM_CLASSES)
    params, stats = jax_init_params(jax.random.PRNGKey(0), modules,
                                    (HEIGHT, WIDTH))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    params["instance_head"]["center_head"]["conv"]["bias"][:] = CENTER_BIAS
    frames = np.random.default_rng(0).integers(
        0, 256, (2, HEIGHT, WIDTH, 3), dtype=np.uint8)

    ref = JaxCodepsNet(modules, params, stats, thing_list=THINGS)(
        frames, mode="eval")
    ref = {k: np.array(v) for k, v in ref.items() if v is not None}

    port_cfg = _cfg(get_cfg_defaults_adapt)
    port_modules = build_modules(port_cfg, NUM_CLASSES, device="cpu")
    load_from_jax(port_modules, params, stats, port_cfg)
    ours = CodepsNet(port_modules, thing_list=THINGS, device="cpu")(
        frames, mode="eval")
    assert ours.pop("thing_mask") is None
    return ref, {k: v.numpy() for k, v in ours.items()}


def test_slice_outputs_have_the_jax_keys_shapes_and_dtypes(outputs):
    ref, ours = outputs
    assert set(ours) == set(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        assert ours[key].dtype == ref[key].dtype, key


@pytest.mark.parametrize("key", ["depth", "semantic_soft", "center",
                                 "offset"])
def test_slice_head_outputs_match(outputs, key):
    ref, ours = outputs
    err = np.abs(ours[key] - ref[key]).max()
    assert err <= REL_TOL * np.abs(ref[key]).max(), (key, err)


def test_fusion_on_jax_head_outputs_is_exact(outputs):
    ref, _ = outputs
    pan, inst, centers = panoptic_fusion_batch(
        torch.from_numpy(ref["semantic_soft"]),
        torch.from_numpy(ref["center"]), torch.from_numpy(ref["offset"]),
        THINGS)
    np.testing.assert_array_equal(inst.numpy(), ref["instance"])
    np.testing.assert_array_equal(pan.numpy(), ref["panoptic"])
    assert centers.valid.any(dim=1).all(), "every frame needs a center"
    assert (ref["instance"] > 0).any()


def _nearest_center_margin(center, offsets):
    """Per pixel: gap between the second-nearest and the nearest
    squared distance to the frame's centers, and the nearest distance."""
    from codeps_torch.ops.panoptic import find_instance_centers
    centers = find_instance_centers(torch.from_numpy(center[..., 0]))
    yx = centers.yx.numpy()[centers.valid.numpy()]
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    loc = np.stack([yy + offsets[..., 0], xx + offsets[..., 1]], -1)
    d2 = ((loc[:, :, None, :] - yx[None, None]) ** 2).sum(-1)
    d2 = np.sort(d2, axis=-1)
    second = d2[..., 1] if d2.shape[-1] > 1 else np.full(d2.shape[:2],
                                                         np.inf)
    return second - d2[..., 0], np.sqrt(second)


def test_slice_end_to_end_maps_agree_off_ties(outputs):
    ref, ours = outputs
    sem_tol = REL_TOL * np.abs(ref["semantic_soft"]).max()
    top2 = np.sort(ref["semantic_soft"], axis=-1)[..., -2:]
    sem_firm = top2[..., 1] - top2[..., 0] > 2 * sem_tol
    assert sem_firm.mean() > 0.95
    np.testing.assert_array_equal(ours["semantic"][sem_firm],
                                  ref["semantic"][sem_firm])

    off_tol = REL_TOL * np.abs(ref["offset"]).max()
    for b in range(ref["panoptic"].shape[0]):
        margin, reach = _nearest_center_margin(ref["center"][b],
                                               ref["offset"][b])
        # |d1^2 - d2^2| moves by at most 2 * d * |delta| + |delta|^2 per
        # center for an offset error |delta| <= sqrt(2) * off_tol.
        delta = np.sqrt(2.0) * off_tol
        grp_firm = margin > 2 * (2 * reach * delta + delta ** 2)
        firm = sem_firm[b] & grp_firm
        assert firm.mean() > 0.9, firm.mean()
        np.testing.assert_array_equal(ours["panoptic"][b][firm],
                                      ref["panoptic"][b][firm])
        assert (ref["instance"][b] > 0).any(), "no instance to compare"
