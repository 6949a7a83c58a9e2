"""The port's learning-rate schedules, Adam and skip ring against the
JAX package's (tolerances in ``tests/test_torch_metrics.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from codeps_tpu.tasks import optim as joptim
from codeps_tpu.tasks.adapt import (push_ring_buffer as jax_push,
                                    skip_decision as jax_skip)

from codeps_torch.tasks import optim
from codeps_torch.tasks.adapt import push_ring_buffer, skip_decision


@pytest.mark.parametrize("method,constant_ending",
                         [("linear", 0.0), ("constant", 0.0),
                          ("linear", 0.3)])
def test_warmup_poly_schedule_matches(method, constant_ending):
    args = (1e-3, 500, 0.01, 50, method, 0.9, constant_ending)
    ref = joptim.warmup_poly_schedule(*args)
    ours = optim.warmup_poly_schedule(*args)
    for count in (0, 1, 25, 49, 50, 51, 300, 480, 499, 500, 700):
        # JAX forms 1 - count / max_iters in float32, whose relative error
        # grows as the difference nears 0
        rtol = 5e-7 / max(1.0 - count / 500, 1.0 / 500)
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=rtol, atol=1e-12, err_msg=count)


def test_step_lr_schedule_matches():
    ref = joptim.step_lr_schedule(1e-4, 2, 0.1, 30)
    ours = optim.step_lr_schedule(1e-4, 2, 0.1, 30)
    for count in (0, 29, 30, 59, 60, 61, 119, 120, 500):
        np.testing.assert_allclose(ours(count), float(ref(count)),
                                   rtol=1e-6, err_msg=count)


def test_adam_matches_optax():
    """Three steps of the port's Adam (torch defaults) against optax's
    adam with the same learning rate on the same gradients."""
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) for _ in range(3)]
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    ref, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(ref)
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    adam = optim.build_optimizer([param], 1e-3)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, ref)
        ref = optax.apply_updates(ref, updates)
        param.grad = torch.from_numpy(g)
        adam.step()
    # updates of ~1e-3 on weights of ~1: the float32 rounding of the
    # weights themselves (a few ulp of max|w|) bounds the agreement
    err = np.abs(param.detach().numpy() - np.asarray(ref)).max()
    assert err <= 4 * np.finfo(np.float32).eps * np.abs(w0).max(), err
    assert np.abs(np.asarray(ref) - w0).max() > 1e-3


@pytest.mark.parametrize("count,dist", [(5, 0.5), (300, 0.01), (300, 0.5)])
def test_skip_ring_matches(count, dist):
    buf = np.linspace(0.2, 1.0, 300).astype(np.float32)
    buf[count:] = 0.0
    head = count % 300 if count < 300 else 17
    args_j = (jnp.asarray(buf), jnp.asarray(count, jnp.int32),
              jnp.asarray(head, jnp.int32))
    args_t = (torch.from_numpy(buf), torch.tensor(count), torch.tensor(head))
    skip_j = jax_skip(args_j[0], args_j[1], jnp.asarray(dist, jnp.float32))
    skip_t = skip_decision(args_t[0], args_t[1], torch.tensor(dist))
    assert bool(skip_t) == bool(skip_j) == (count == 300 and dist < 0.06)
    ref = jax_push(*args_j, jnp.asarray(dist, jnp.float32), skip_j)
    ours = push_ring_buffer(*args_t, torch.tensor(dist), skip_t)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
