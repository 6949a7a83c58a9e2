"""The port's camera, pose, warp and grid_sample against the JAX package,
forward and gradient (``jax.grad`` against autograd), on the same
numpy-seeded inputs in float32.

Layouts: the JAX functions take NHWC images, depth and points; the port
takes NCHW and returns pixel and sampling coordinates channel-last, as
``F.grid_sample`` wants them. Each comparison transposes at the boundary.

Tolerances: 1e-5 of the largest reference value for the closed-form
geometry (the same float32 formulas, summed in another order), 1e-4 for
warped images and their gradients (bilinear weights of coordinates that
carry the geometry's rounding). Gradients with respect to the sampling
grid are compared away from the border clamp and from integer
coordinates: there ``jnp.clip`` and ``F.grid_sample`` take different
one-sided derivatives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.geometry import camera as jcam
from codeps_tpu.geometry import pose as jpose
from codeps_tpu.geometry import warp as jwarp
from codeps_tpu.ops.grid_sample import grid_sample as jgrid_sample

from codeps_torch.geometry import camera, pose, warp
from codeps_torch.ops.grid_sample import grid_sample

B, H, W = 2, 12, 20


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(ours, ref, rel, what=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = rel * float(np.abs(ref).max())
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _intrinsics():
    return np.asarray([[15.0, 14.0, W / 2, H / 2],
                       [11.0, 12.5, W / 2 - 1.5, H / 2 + 0.5]], np.float32)


def _depth(seed=0):
    return _rng(seed).uniform(1.0, 20.0, (B, H, W, 1)).astype(np.float32)


def _poses(seed=1, invert=False):
    rng = _rng(seed)
    axisangle = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    translation = rng.normal(0, 0.2, (B, 3)).astype(np.float32)
    ref = jpose.transformation_from_parameters(
        jnp.asarray(axisangle), jnp.asarray(translation), invert=invert)
    ours = pose.transformation_from_parameters(
        torch.from_numpy(axisangle), torch.from_numpy(translation),
        invert=invert)
    return ours, np.asarray(ref)


def test_scale_intrinsics_to_size():
    k = _intrinsics()
    ref = jcam.scale_intrinsics_to_size(jnp.asarray(k), (H, W), (H // 4,
                                                                  W // 4))
    ours = camera.scale_intrinsics_to_size(torch.from_numpy(k), (H, W),
                                           (H // 4, W // 4))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_backproject_and_project():
    k, depth = _intrinsics(), _depth()
    ref_points = jcam.backproject(jnp.asarray(depth), jnp.asarray(k))
    points = camera.backproject(_to_nchw(depth), torch.from_numpy(k))
    _close(points.permute(0, 2, 3, 1), ref_points, 1e-6, "points")
    ref_uv = jcam.project(ref_points, jnp.asarray(k))
    _close(camera.project(points, torch.from_numpy(k)), ref_uv, 1e-6, "uv")


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(invert):
    ours, ref = _poses(invert=invert)
    _close(ours, ref, 1e-6, "transform")
    np.testing.assert_array_equal(ours.numpy()[:, 3], [[0, 0, 0, 1]] * B)


def test_transform_points():
    ours_t, ref_t = _poses()
    points = _rng(3).normal(0, 5, (B, H, W, 3)).astype(np.float32)
    ref = jpose.transform_points(jnp.asarray(ref_t), jnp.asarray(points))
    ours = pose.transform_points(ours_t, _to_nchw(points))
    _close(ours.permute(0, 2, 3, 1), ref, 1e-5, "points")


def test_pose_gradient_matches_jax():
    rng = _rng(4)
    axisangle = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    translation = rng.normal(0, 0.2, (B, 3)).astype(np.float32)
    weights = rng.normal(size=(B, 4, 4)).astype(np.float32)

    def jax_fn(a, t):
        return jnp.sum(jpose.transformation_from_parameters(
            a, t, invert=True) * weights)

    ref_a, ref_t = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(axisangle),
                                                    jnp.asarray(translation))
    a = torch.from_numpy(axisangle).requires_grad_()
    t = torch.from_numpy(translation).requires_grad_()
    (pose.transformation_from_parameters(a, t, invert=True)
     * torch.from_numpy(weights)).sum().backward()
    _close(a.grad, ref_a, 1e-5, "d/d axisangle")
    _close(t.grad, ref_t, 1e-5, "d/d translation")


def test_warp_coordinates_and_image():
    ours_t, ref_t = _poses()
    k, depth = _intrinsics(), _depth()
    img = _rng(5).uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    ref_coords = jwarp.warp_coordinates(jnp.asarray(k), jnp.asarray(depth),
                                        jnp.asarray(ref_t))
    coords = warp.warp_coordinates(torch.from_numpy(k), _to_nchw(depth),
                                   ours_t)
    _close(coords, ref_coords, 1e-5, "coords")
    ref_img = jwarp.warp_image(jnp.asarray(k), jnp.asarray(img),
                               jnp.asarray(depth), jnp.asarray(ref_t))
    ours = warp.warp_image(torch.from_numpy(k), _to_nchw(img),
                           _to_nchw(depth), ours_t)
    _close(ours.permute(0, 2, 3, 1), ref_img, 1e-4, "warped image")


def test_warp_gradient_matches_jax():
    """d(weighted warped image)/d(depth, image), the path the
    reconstruction loss trains the depth head through."""
    ours_t, ref_t = _poses()
    k, depth = _intrinsics(), _depth()
    rng = _rng(6)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    weights = rng.normal(size=(B, H, W, 3)).astype(np.float32)

    def jax_fn(d, x):
        return jnp.sum(jwarp.warp_image(jnp.asarray(k), x, d,
                                        jnp.asarray(ref_t)) * weights)

    ref_d, ref_x = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(depth),
                                                    jnp.asarray(img))
    d = _to_nchw(depth).requires_grad_()
    x = _to_nchw(img).requires_grad_()
    (warp.warp_image(torch.from_numpy(k), x, d, ours_t)
     * _to_nchw(weights)).sum().backward()
    _close(d.grad.permute(0, 2, 3, 1), ref_d, 1e-4, "d/d depth")
    _close(x.grad.permute(0, 2, 3, 1), ref_x, 1e-4, "d/d image")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_forward(mode):
    rng = _rng(7)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    # inside, on the border and beyond it (clamped)
    grid = rng.uniform(-1.3, 1.3, (B, 9, 11, 2)).astype(np.float32)
    grid[:, 0, :3] = [[-1.0, 1.0], [1.0, -1.0], [0.0, 0.0]]
    ref = jgrid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode)
    ours = grid_sample(_to_nchw(img), torch.from_numpy(grid), mode=mode)
    _close(ours.permute(0, 2, 3, 1), ref, 1e-6, mode)


def test_grid_sample_gradient_matches_jax():
    rng = _rng(8)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    # strictly inside, and away from integer pixel coordinates
    x = rng.integers(0, W - 1, (B, 9, 11)) + rng.uniform(0.1, 0.9,
                                                         (B, 9, 11))
    y = rng.integers(0, H - 1, (B, 9, 11)) + rng.uniform(0.1, 0.9,
                                                         (B, 9, 11))
    grid = np.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1],
                    -1).astype(np.float32)
    weights = rng.normal(size=(B, 9, 11, 3)).astype(np.float32)

    def jax_fn(im, g):
        return jnp.sum(jgrid_sample(im, g) * weights)

    ref_img, ref_grid = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(img),
                                                         jnp.asarray(grid))
    im = _to_nchw(img).requires_grad_()
    g = torch.from_numpy(grid).requires_grad_()
    (grid_sample(im, g) * _to_nchw(weights)).sum().backward()
    _close(im.grad.permute(0, 2, 3, 1), ref_img, 1e-5, "d/d image")
    _close(g.grad, ref_grid, 1e-4, "d/d grid")
