"""The host camera warp (``c2c_prewarp``) and the pair gather at its
taps (``grid_sample_pair_pre``) against ``codeps_tpu`` (tolerances in
``tests/test_torch_mixup.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codeps_tpu.ops.grid_sample import grid_sample_pair_pre as jax_pair
from codeps_tpu.tasks.mixup_prep import c2c_prewarp as jax_c2c_prewarp

from codeps_torch.ops.grid_sample import grid_sample_pair_pre, prewarp_host
from codeps_torch.tasks.adapt import batch_to_device
from codeps_torch.tasks.mixup_prep import c2c_prewarp
from torch_mixup_cases import (CITYSCAPES, HS, HT, KITTI_360, WS, WT,
                               _camera)

NC = 14


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
