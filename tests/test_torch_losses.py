"""The port's losses against the JAX package's, value and gradient, on the
same numpy-seeded inputs in float32.

The reconstruction loss takes the automask normals that JAX draws, through
the port's injected noise source (one (B, 2, h, w) draw per scale, the
JAX (B, h, w, 2) draw transposed).

Tolerances: 1e-5 relative for values (the same float32 formulas summed in
another order; the photometric loss also carries the warp's rounding);
gradients 1e-4 of their largest reference entry, except where a
comparison says otherwise.

The semantic and instance losses are in
``tests/test_torch_losses_semantic.py`` (a file holds under 13 tests).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.geometry.pose import transformation_from_parameters
from codeps_tpu.losses import photometric as jphoto
from codeps_tpu.losses import smoothness as jsmooth

from codeps_torch.losses import photometric, smoothness
from torch_loss_cases import B, GRAD_REL, REL, H, W, _close, _nchw, _nhwc



def _triplet(seed):
    """Images [t, t-1, t+1] (B, H, W, 3), a depth map, two small poses and
    the intrinsics: the target frame is a shifted copy of the neighbors so
    that the warp finds structure."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (B, H, W + 4, 3)).astype(np.float32)
    images = [base[:, :, 2:-2], base[:, :, 1:-3], base[:, :, 3:-1]]
    images = [np.clip(im + rng.normal(0, 0.02, im.shape), 0, 1).astype(
        np.float32) for im in images]
    depth = rng.uniform(2.0, 30.0, (B, H, W, 1)).astype(np.float32)
    poses = [np.asarray(transformation_from_parameters(
        jnp.asarray(rng.normal(0, 0.01, (B, 3)).astype(np.float32)),
        jnp.asarray(rng.normal(0, 0.1, (B, 3)).astype(np.float32)),
        invert=inv)) for inv in (True, False)]
    intrinsics = np.tile(np.asarray([[30.0, 30.0, W / 2, H / 2]],
                                    np.float32), (B, 1))
    return images, depth, poses, intrinsics


def test_ssim_and_photometric_error():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    _close(_nhwc(photometric.ssim(_nchw(x), _nchw(y))),
           jphoto.ssim(jnp.asarray(x), jnp.asarray(y)), REL, "ssim")
    stats = photometric.ssim_target_stats(_nchw(y))
    _close(_nhwc(photometric.photometric_error(_nchw(x), _nchw(y),
                                               target_stats=stats)),
           jphoto.photometric_error(jnp.asarray(x), jnp.asarray(y)), REL,
           "photometric error")


def _jax_noise(key, num_scales, batch):
    draws = []
    for s in range(num_scales):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(
            sub, (batch, H >> s, W >> s, 2), jnp.float32)).transpose(
                0, 3, 1, 2))
    return draws


@pytest.mark.parametrize("num_scales", [2, 5])
@pytest.mark.parametrize("per_sample", [False, True])
def test_reconstruction_loss_and_gradient(num_scales, per_sample):
    images, depth, poses, intrinsics = _triplet(1)
    key = jax.random.PRNGKey(5)
    weights = np.asarray([0.7, 1.3], np.float32)

    def jax_fn(d, p0, p1):
        loss = jphoto.reconstruction_loss(
            key, jnp.asarray(intrinsics), [jnp.asarray(im) for im in images],
            d, [p0, p1], num_scales=num_scales, per_sample=per_sample)
        return (jnp.sum(loss * weights) if per_sample else loss), loss

    (_, ref_loss), ref_grads = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(depth), *(jnp.asarray(p) for p in poses))

    draws = _jax_noise(key, num_scales, B)
    d = _nchw(depth).requires_grad_()
    ps = [torch.from_numpy(np.array(p)).requires_grad_() for p in poses]
    loss = photometric.reconstruction_loss(
        torch.from_numpy(intrinsics), [_nchw(im) for im in images], d, ps,
        num_scales=num_scales, per_sample=per_sample,
        noise=lambda shape: torch.from_numpy(np.array(draws.pop(0))))
    assert not draws
    assert tuple(loss.shape) == ((B,) if per_sample else ())
    _close(loss, ref_loss, REL, "loss")
    (loss * torch.from_numpy(weights)).sum().backward() if per_sample \
        else loss.backward()
    _close(d.grad.permute(0, 2, 3, 1), ref_grads[0], GRAD_REL, "d/d depth")
    for i in range(2):
        _close(ps[i].grad, ref_grads[1 + i], GRAD_REL, f"d/d pose {i}")


def test_reconstruction_loss_per_sample_mean_is_the_batch_loss():
    images, depth, poses, intrinsics = _triplet(2)
    gen = torch.Generator().manual_seed(0)
    args = (torch.from_numpy(intrinsics), [_nchw(im) for im in images],
            _nchw(depth), [torch.from_numpy(np.array(p)) for p in poses])
    vec = photometric.reconstruction_loss(*args, per_sample=True,
                                          generator=gen)
    gen.manual_seed(0)
    scalar = photometric.reconstruction_loss(*args, generator=gen)
    torch.testing.assert_close(vec.mean(), scalar, rtol=1e-6, atol=0)


@pytest.mark.parametrize("per_sample", [False, True])
def test_edge_aware_smoothness_and_gradient(per_sample):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    disp = rng.uniform(0.01, 1, (B, H, W, 1)).astype(np.float32)
    ref = jsmooth.edge_aware_smoothness_loss(jnp.asarray(img),
                                             jnp.asarray(disp), per_sample)
    ref_grad = jax.grad(lambda x: jnp.sum(jsmooth.edge_aware_smoothness_loss(
        jnp.asarray(img), x, per_sample)))(jnp.asarray(disp))
    x = _nchw(disp).requires_grad_()
    loss = smoothness.edge_aware_smoothness_loss(_nchw(img), x, per_sample)
    _close(loss, ref, REL, "loss")
    loss.sum().backward()
    _close(x.grad.permute(0, 2, 3, 1), ref_grad, GRAD_REL, "gradient")


