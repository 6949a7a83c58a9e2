"""The port's center finding and panoptic fusion against
``codeps_tpu``'s; ``tests/test_torch_ops.py`` says more."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codeps_tpu.ops.panoptic as jax_panoptic

from codeps_torch.ops import panoptic

THINGS = (9, 10, 11, 12, 13)
NUM_CLASSES = 14


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(array):
    return torch.from_numpy(np.array(array))


def _heatmap(rng, height, width, num_peaks):
    yy, xx = np.mgrid[0:height, 0:width]
    heat = np.zeros((height, width), np.float32)
    for y, x in zip(rng.integers(0, height, num_peaks),
                    rng.integers(0, width, num_peaks)):
        heat = np.maximum(heat, rng.uniform(0.3, 1.0) * np.exp(
            -((yy - y) ** 2 + (xx - x) ** 2) / rng.uniform(4, 30)))
    return heat.astype(np.float32)


@pytest.mark.parametrize("top_k", [8, 200])
@pytest.mark.parametrize("kind", ["peaks", "noise"])
def test_find_instance_centers_exact(top_k, kind):
    """'peaks' leaves few candidates (unsaturated at top_k 200); 'noise'
    leaves hundreds (saturated at both)."""
    rng = np.random.default_rng(4)
    if kind == "peaks":
        heat = _heatmap(rng, 48, 96, 12)
    else:
        heat = rng.uniform(0, 1, (48, 96)).astype(np.float32)
    ours = panoptic.find_instance_centers(_t(heat), top_k=top_k)
    ref = jax_panoptic.find_instance_centers(jnp.asarray(heat), top_k=top_k)
    valid = np.asarray(ref.valid)
    assert valid.any()
    np.testing.assert_array_equal(ours.valid.numpy(), valid)
    np.testing.assert_array_equal(ours.yx.numpy()[valid],
                                  np.asarray(ref.yx)[valid])
    np.testing.assert_array_equal(ours.score.numpy()[valid],
                                  np.asarray(ref.score)[valid])


def _head_outputs(rng, batch, height, width):
    sem = rng.dirichlet(np.full(NUM_CLASSES, 0.3),
                        (batch, height, width)).astype(np.float32)
    center = np.stack([_heatmap(rng, height, width, 6)
                       for _ in range(batch)])[..., None]
    offsets = rng.normal(0, 3, (batch, height, width, 2)).astype(np.float32)
    return sem, center, offsets


@pytest.mark.parametrize("stuff_area", [0, 40])
def test_merge_and_panoptic_segmentation_exact(stuff_area):
    rng = np.random.default_rng(5)
    sem, center, offsets = _head_outputs(rng, 1, 32, 64)
    labels = sem[0].argmax(-1).astype(np.int32)
    labels[rng.random(labels.shape) < 0.05] = 255               # void
    instance = rng.integers(0, 9, labels.shape).astype(np.int32)
    instance[~np.isin(labels, THINGS)] = 0
    valid = np.ones(8, bool)
    ours = panoptic.merge_semantic_and_instance(
        _t(labels), _t(instance), _t(valid), THINGS, stuff_area=stuff_area,
        num_classes=NUM_CLASSES).numpy()
    ref = np.asarray(jax_panoptic.merge_semantic_and_instance(
        jnp.asarray(labels), jnp.asarray(instance), jnp.asarray(valid),
        THINGS, stuff_area=stuff_area, num_classes=NUM_CLASSES))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)

    for sem_in in (sem[0], labels):
        ours = panoptic.get_panoptic_segmentation(
            _t(sem_in), _t(center[0, ..., 0]), _t(offsets[0]), THINGS,
            stuff_area=stuff_area, top_k=16, num_classes=NUM_CLASSES)
        ref = jax_panoptic.get_panoptic_segmentation(
            jnp.asarray(sem_in), jnp.asarray(center[0, ..., 0]),
            jnp.asarray(offsets[0]), THINGS, stuff_area=stuff_area,
            top_k=16, num_classes=NUM_CLASSES, use_pallas=False)
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
        assert ours[1].numpy().max() > 0


def test_panoptic_fusion_batch_exact():
    rng = np.random.default_rng(6)
    sem, center, offsets = _head_outputs(rng, 2, 32, 64)
    pan, inst, centers = panoptic.panoptic_fusion_batch(
        _t(sem), _t(center), _t(offsets), THINGS)
    ref_pan, ref_inst, ref_centers = jax_panoptic.panoptic_fusion_batch(
        jnp.asarray(sem), jnp.asarray(center), jnp.asarray(offsets), THINGS)
    np.testing.assert_array_equal(centers.valid.numpy(),
                                  np.asarray(ref_centers.valid))
    np.testing.assert_array_equal(inst.numpy(), np.asarray(ref_inst))
    np.testing.assert_array_equal(pan.numpy(), np.asarray(ref_pan))
    assert pan.dtype == inst.dtype == torch.int32
    assert inst.numpy().max() > 0
