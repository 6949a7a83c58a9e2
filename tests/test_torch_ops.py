"""The port's tensor ops against their ``codeps_tpu`` counterparts.

Inputs come from ``numpy.random.default_rng`` and reach both packages as
numpy arrays; everything runs on the CPU. Integer outputs and
thresholds must match exactly; the resize tolerance is stated below.

Split over ``tests/test_torch_ops*.py`` (under 13 tests a file).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from codeps_tpu.ops.normalize import maybe_normalize as jax_maybe_normalize
from codeps_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from codeps_tpu.ops.resize import upsample_nearest_2x as jax_upsample_2x

from codeps_torch.ops import normalize, resize


def _t(array):
    return torch.from_numpy(np.array(array))


def test_normalize_uint8_exact_and_float_passthrough():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 8, 16, 3), dtype=np.uint8)
    ours = normalize.maybe_normalize(_t(img)).numpy()
    ref = np.asarray(jax_maybe_normalize(jnp.asarray(img)))
    np.testing.assert_array_equal(ours, ref)
    floats = _t(rng.normal(size=(1, 4, 4, 3)).astype(np.float32))
    assert normalize.maybe_normalize(floats) is floats


# Bilinear: both sides blend the same two taps in float32, but torch
# computes the source coordinate in float32 where the JAX matrices use
# float64, so a weight may be off by about eps32 * in_size. On inputs in
# [0, 1) that bounds the error by eps32 * max(H, W) = 2.4e-6 here; the
# largest seen is 1.1e-6 (align_corners=True), 8e-7 otherwise.
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(24, 40), (5, 7), (16, 32), (3, 50)])
def test_resize_bilinear_matches_jax(align_corners, size):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 12, 20, 3)).astype(np.float32)
    ours = resize.resize_bilinear(_t(img), size, align_corners).numpy()
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(img), size,
                                         align_corners))
    assert ours.shape == ref.shape
    atol = np.finfo(np.float32).eps * max(img.shape[1:3])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_upsample_nearest_2x_exact():
    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    ours = resize.upsample_nearest_2x(_t(img)).numpy()
    ref = np.asarray(jax_upsample_2x(jnp.asarray(img)))
    np.testing.assert_array_equal(ours, ref)
