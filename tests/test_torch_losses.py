"""The port's losses against the JAX package's, value and gradient, on the
same numpy-seeded inputs in float32.

The reconstruction loss takes the automask normals that JAX draws, through
the port's injected noise source (one (B, 2, h, w) draw per scale, the
JAX (B, h, w, 2) draw transposed).

Tolerances: 1e-5 relative for values (the same float32 formulas summed in
another order; the photometric loss also carries the warp's rounding);
gradients 1e-4 of their largest reference entry, except where a
comparison says otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.geometry.pose import transformation_from_parameters
from codeps_tpu.losses import instance as jinst
from codeps_tpu.losses import photometric as jphoto
from codeps_tpu.losses import semantic as jsem
from codeps_tpu.losses import smoothness as jsmooth
from codeps_tpu.ops import topk as jtopk

from codeps_torch.losses import instance, photometric, semantic, smoothness
from codeps_torch.ops.topk import top_k_mean

B, H, W, C = 2, 32, 64, 14
REL = 1e-5
GRAD_REL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _close(ours, ref, rel, what=""):
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                      else ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = rel * float(np.abs(ref).max())
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"


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


def _probs(rng, shape):
    logits = rng.normal(0, 2, shape).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def test_cross_entropy_per_pixel():
    rng = np.random.default_rng(4)
    pred = _probs(rng, (B, H, W, C))
    target = rng.integers(0, C, (B, H, W)).astype(np.int32)
    target[0, :3] = 255
    cw = rng.uniform(0.5, 2.0, C).astype(np.float32)
    ref = jsem.cross_entropy_per_pixel(jnp.asarray(pred), jnp.asarray(target),
                                       jnp.asarray(cw))
    ours = semantic.cross_entropy_per_pixel(_nchw(pred),
                                            torch.from_numpy(target),
                                            torch.from_numpy(cw))
    _close(ours, ref, REL, "ce")
    assert (ours[0, :3] == 0).all()


@pytest.mark.parametrize("ignore_labels", [None, [3, 11]])
@pytest.mark.parametrize("top_k", [1.0, 0.2])
def test_semantic_loss_and_gradient(ignore_labels, top_k):
    rng = np.random.default_rng(5)
    pred = _probs(rng, (B, H, W, C))
    target = rng.integers(0, C, (B, H, W)).astype(np.int32)
    target[1, 4:6] = 255
    weights = rng.uniform(0.5, 2.0, (B, H, W)).astype(np.float32)
    cw = list(rng.uniform(0.5, 2.0, C).astype(np.float32))

    def jax_fn(p):
        return jsem.semantic_loss(p, jnp.asarray(target),
                                  jnp.asarray(weights), class_weights=cw,
                                  ignore_labels=ignore_labels,
                                  top_k_percent_pixels=top_k)

    ref = jax_fn(jnp.asarray(pred))
    ref_grad = jax.grad(jax_fn)(jnp.asarray(pred))
    x = _nchw(pred).requires_grad_()
    loss = semantic.semantic_loss(x, torch.from_numpy(target),
                                  torch.from_numpy(weights),
                                  class_weights=cw,
                                  ignore_labels=ignore_labels,
                                  top_k_percent_pixels=top_k)
    _close(loss, ref, REL, "loss")
    loss.backward()
    _close(x.grad.permute(0, 2, 3, 1), ref_grad, GRAD_REL, "gradient")


def test_top_k_mean_and_ties():
    """Value and gradient of the JAX threshold rule, with ties at the k-th
    value: the tie mass spreads evenly over the tied entries."""
    rng = np.random.default_rng(6)
    flat = rng.uniform(0, 1, 1000).astype(np.float32)
    flat[::7] = flat[100]              # a block of ties at one value
    flat[5] = -0.0
    for k in (1, 137, 200, 999):
        ref = jtopk.top_k_mean(jnp.asarray(flat), k)
        ref_grad = jax.grad(lambda v: jtopk.top_k_mean(v, k))(
            jnp.asarray(flat))
        x = torch.from_numpy(flat.copy()).requires_grad_()
        value = top_k_mean(x, k)
        value.backward()
        _close(value, ref, 1e-6, f"value k={k}")
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                                   rtol=1e-6, atol=1e-9)
        expect = np.sort(flat)[::-1][:k].astype(np.float64).mean()
        assert abs(float(value.detach()) - expect) <= 1e-6 * abs(expect)


def test_instance_losses_and_gradients():
    rng = np.random.default_rng(7)
    center = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    center_gt = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    offset = rng.normal(0, 4, (B, H, W, 2)).astype(np.float32)
    offset_gt = rng.normal(0, 4, (B, H, W, 2)).astype(np.float32)
    mask_probs = _probs(rng, (B, H, W, 2))
    mask_gt = rng.integers(0, 2, (B, H, W)).astype(np.int32)
    mask_gt[0, 0] = 255
    ema = rng.normal(0, 1, (B, H, W, 1)).astype(np.float32)

    cases = [
        ("center", jinst.center_loss, instance.center_loss, center,
         center_gt, False),
        ("offset", jinst.offset_loss, instance.offset_loss, offset,
         offset_gt, False),
        ("binary mask", jinst.binary_mask_loss, instance.binary_mask_loss,
         mask_probs, mask_gt, True),
        ("ema consistency", jinst.ema_consistency_loss,
         instance.ema_consistency_loss, center, ema, False),
    ]
    for what, jfn, fn, pred, target, channels_first in cases:
        ref = jfn(jnp.asarray(pred), jnp.asarray(target))
        ref_grad = jax.grad(lambda p: jfn(p, jnp.asarray(target)))(
            jnp.asarray(pred))
        x = (_nchw(pred) if channels_first
             else torch.from_numpy(pred)).requires_grad_()
        loss = fn(x, torch.from_numpy(target))
        _close(loss, ref, REL, what)
        loss.backward()
        grad = x.grad.permute(0, 2, 3, 1) if channels_first else x.grad
        _close(grad, ref_grad, GRAD_REL, f"{what} gradient")
