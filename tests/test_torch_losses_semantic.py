"""The port's semantic CE, top-k mean and instance losses against the
JAX package's, value and gradient (tolerances in
``tests/test_torch_losses.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.losses import instance as jinst
from codeps_tpu.losses import semantic as jsem
from codeps_tpu.ops import topk as jtopk

from codeps_torch.losses import instance, semantic
from codeps_torch.ops.topk import top_k_mean
from torch_loss_cases import B, C, GRAD_REL, REL, H, W, _close, _nchw


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
