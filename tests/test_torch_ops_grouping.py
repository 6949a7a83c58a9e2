"""The port's k-th largest and plain pixel grouping against their
``codeps_tpu`` counterparts (the grouping also against the Pallas kernel
in interpret mode); ``tests/test_torch_ops.py`` says more."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import codeps_tpu.ops.panoptic as jax_panoptic
from codeps_tpu.ops.pallas.grouping import group_pixels_pallas
from codeps_tpu.ops.topk import kth_largest as jax_kth_largest

from codeps_torch.ops import grouping, topk


def _t(array):
    return torch.from_numpy(np.array(array))


@pytest.mark.parametrize("k", [1, 7, 100, 4096])
def test_kth_largest_exact_with_ties_and_zero_sentinel(k):
    rng = np.random.default_rng(3)
    values = np.zeros(4096, np.float32)
    hits = rng.choice(4096, 60, replace=False)
    values[hits] = rng.choice(np.float32([0.25, 0.5, 0.7, 0.9]), 60)
    values[hits[:3]] = 1.0                                   # ties at the top
    values[hits[3]] = -0.0
    ours = topk.kth_largest(_t(values), k).item()
    ref = float(jax_kth_largest(jnp.asarray(values), k))
    assert ours == ref


def _grouping_case(name):
    """(centers yx (K, 2), valid (K,), offsets (H, W, 2)) as numpy; the
    first three follow tests/test_pallas_grouping.py."""
    rng = np.random.default_rng(17)
    height, width, k = 32, 128, 8
    yx = rng.uniform([0, 0], [height, width], (k, 2)).astype(np.float32)
    valid = np.zeros((k,), bool)
    valid[:5] = True
    offsets = rng.normal(0, 5, (height, width, 2)).astype(np.float32)
    if name == "no_valid":
        valid[:] = False
        offsets = np.zeros((16, width, 2), np.float32)
    elif name == "heatmap":
        heat = np.zeros((height, width), np.float32)
        yy, xx = np.mgrid[0:height, 0:width]
        for y, x in ((5, 20), (18, 90), (28, 40)):
            heat = np.maximum(heat, np.exp(-((yy - y) ** 2 + (xx - x) ** 2)
                                           / 50.0))
        centers = jax_panoptic.find_instance_centers(jnp.asarray(heat),
                                                     top_k=8)
        yx, valid = np.asarray(centers.yx), np.asarray(centers.valid)
        offsets = rng.normal(0, 2, (height, width, 2)).astype(np.float32)
    elif name == "nan_offsets":
        offsets[rng.random((height, width)) < 0.1, 0] = np.nan
        offsets[rng.random((height, width)) < 0.05, 1] = np.nan
        valid[0] = False                  # all-NaN pixels keep id 1
    elif name == "duplicate_centers":
        yx[3] = yx[1]
        yx[4] = np.round(yx[4])
        offsets = np.round(offsets)               # exact ties on the grid
        yx = np.round(yx)
    elif name == "k_not_multiple_of_8":
        k = 13
        yx = rng.uniform([0, 0], [height, width], (k, 2)).astype(np.float32)
        valid = rng.random(k) < 0.7
        valid[2] = True
    return yx.astype(np.float32), valid, offsets.astype(np.float32)


GROUPING_CASES = ["random", "no_valid", "heatmap", "nan_offsets",
                  "duplicate_centers", "k_not_multiple_of_8"]


@pytest.mark.parametrize("case", GROUPING_CASES)
def test_group_pixels_plain_bit_exact_vs_jax(case):
    yx, valid, offsets = _grouping_case(case)
    ours = grouping.group_pixels(_t(yx), _t(valid), _t(offsets)).numpy()
    ref = np.asarray(jax_panoptic.group_pixels(
        jax_panoptic.Centers(jnp.asarray(yx), jnp.ones(len(yx)),
                             jnp.asarray(valid)), jnp.asarray(offsets)))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    if len(yx) % 8 == 0:
        pallas = np.asarray(group_pixels_pallas(
            jnp.asarray(yx), jnp.asarray(valid), jnp.asarray(offsets),
            interpret=True))
        np.testing.assert_array_equal(ours, pallas)
