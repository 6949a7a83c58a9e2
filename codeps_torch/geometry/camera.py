"""Pinhole camera model with intrinsics as (B, 4) tensors ``[fx, fy, cx, cy]``.

Counterpart of ``codeps_tpu/geometry/camera.py``. Images and depth maps
are NCHW; pixel coordinates come back channel-last, (B, H, W, 2), the
layout ``F.grid_sample`` takes for its grid. Inside a row split
(``parallel/spatial.py``) a depth map is this rank's slab of rows, whose
pixels keep their global row coordinate.
"""

from __future__ import annotations

import numpy as np
import torch

from codeps_torch.parallel import spatial


def make_intrinsics(fx, fy, cx, cy) -> torch.Tensor:
    """Stack scalars (or batched vectors) into a (..., 4) intrinsics tensor."""
    return torch.stack([torch.as_tensor(v) for v in (fx, fy, cx, cy)],
                       dim=-1)


def scale_intrinsics(intrinsics: torch.Tensor, scale_u: float,
                     scale_v: float) -> torch.Tensor:
    """Scale intrinsics by per-axis image-resize factors: fx and cx by
    ``scale_u``, fy and cy by ``scale_v``, each a product in the
    intrinsics' dtype. The factors stay Python numbers: no tensor comes
    from the host, so the call may run inside a CUDA graph's capture."""
    pairs = intrinsics.unflatten(-1, (2, 2))      # [[fx, fy], [cx, cy]]
    return torch.stack([pairs[..., 0] * scale_u, pairs[..., 1] * scale_v],
                       dim=-1).flatten(-2)


def scale_intrinsics_to_size(intrinsics: torch.Tensor,
                             src_size: tuple[int, int],
                             dst_size: tuple[int, int]) -> torch.Tensor:
    """Rescale intrinsics from image size ``src`` to ``dst`` (height, width)."""
    return scale_intrinsics(intrinsics, dst_size[1] / src_size[1],
                            dst_size[0] / src_size[0])


def _columns(intrinsics: torch.Tensor, dtype: torch.dtype, ndim: int):
    """fx, fy, cx, cy, each shaped (B, 1, ...) to broadcast over ``ndim``
    trailing axes."""
    batch = intrinsics.shape[0]
    shape = (batch,) + (1,) * ndim
    return [intrinsics[:, i].to(dtype).reshape(shape) for i in range(4)]


def backproject(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) depth -> (B, 3, H, W) camera-frame points
    ``depth * ((u - cx) / fx, (v - cy) / fy, 1)``."""
    _, _, height, width = depth.shape
    dtype, device = depth.dtype, depth.device
    u = torch.arange(width, dtype=dtype, device=device)[None, None, None, :]
    first = spatial.row_offset(height, width)
    v = torch.arange(first, first + height, dtype=dtype,
                     device=device)[None, None, :, None]
    fx, fy, cx, cy = _columns(intrinsics, dtype, 3)
    x3d = depth * (u - cx) / fx
    y3d = depth * (v - cy) / fy
    return torch.cat([x3d, y3d, depth], dim=1)


def project(points: torch.Tensor, intrinsics: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """(B, 3, H, W) camera-frame points -> (B, H, W, 2) pixel coordinates
    (u, v), with the depth clamped to ``eps`` from below."""
    fx, fy, cx, cy = _columns(intrinsics, points.dtype, 2)
    z = torch.clamp(points[:, 2], min=eps)
    u = points[:, 0] / z * fx + cx
    v = points[:, 1] / z * fy + cy
    return torch.stack([u, v], dim=-1)


def intrinsics_from_numpy(fx: float, fy: float, cx: float, cy: float,
                          batch: int = 1) -> np.ndarray:
    """Host-side helper: replicate one camera over a batch."""
    one = np.asarray([fx, fy, cx, cy], dtype=np.float32)
    return np.tile(one[None], (batch, 1))
