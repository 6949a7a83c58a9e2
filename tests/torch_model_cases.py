"""Weights, tolerance and layout helpers shared by
``tests/test_torch_models*.py``."""

import jax
import numpy as np
import pytest
import torch

HEIGHT, WIDTH = 64, 128
NUM_CLASSES = 14
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _perturb(tree, rng, path=()):
    """Redraw BatchNorm statistics/affines and conv biases in place."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _perturb(value, rng, path + (key,))
            continue
        shape = value.shape
        if key == "mean":
            tree[key] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key == "scale":
            tree[key] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif key == "bias":
            tree[key] = rng.normal(0, 0.05, shape).astype(np.float32)
    return tree


def _flax_init(module, *args, **kwargs):
    variables = jax.jit(lambda key: module.init(key, *args, **kwargs))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.array, variables)
    rng = np.random.default_rng(11)
    params = _perturb(variables["params"], rng)
    stats = _perturb(variables.get("batch_stats", {}), rng)
    return params, stats


def _assert_close(ours, ref, what):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = REL_TOL * float(np.abs(ref).max())
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _torch_feats(feats):
    return [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats]
