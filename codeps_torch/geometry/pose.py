"""SE(3) pose math: axis-angle + translation -> 4x4 transforms.

Counterpart of ``codeps_tpu/geometry/pose.py`` (Monodepth2's
``transformation_from_parameters``). The 4x4 products and the point
transform are written as broadcast multiply-adds, so they run in full
float32 whatever the matmul precision setting (the JAX package pins
``Precision.HIGHEST`` for the same reason: pose matrices are near the
identity and a rounded contraction moves the warp by sub-pixels).
"""

from __future__ import annotations

import torch


def rot_from_axisangle(axisangle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (B, 3) axis-angle -> (B, 4, 4) rotation, with
    the reference's 1e-7 guard on the angle."""
    angle = torch.linalg.vector_norm(axisangle, dim=-1, keepdim=True)
    axis = axisangle / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c1 = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    x_c, y_c, z_c = x * c1, y * c1, z * c1
    xy_c, yz_c, zx_c = x * y_c, y * z_c, z * x_c
    zeros = torch.zeros_like(ca)
    ones = torch.ones_like(ca)
    return torch.stack([
        x * x_c + ca, xy_c - zs, zx_c + ys, zeros,
        xy_c + zs, y * y_c + ca, yz_c - xs, zeros,
        zx_c - ys, yz_c + xs, z * z_c + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1).reshape(axisangle.shape[0], 4, 4)


def translation_matrix(translation: torch.Tensor) -> torch.Tensor:
    """(B, 3) translation -> (B, 4, 4) matrix."""
    batch = translation.shape[0]
    eye = torch.eye(4, dtype=translation.dtype, device=translation.device)
    pad = torch.cat([translation, translation.new_zeros(batch, 1)], dim=-1)
    # eye's last row is the selector (0, 0, 0, 1) of the last column, made
    # on the device (no host copy, so safe inside a CUDA graph's capture)
    return eye + pad[:, :, None] * eye[3][None, None, :]


def _matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) @ (B, 4, 4) as a float32 multiply-add."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(dim=2)


def transformation_from_parameters(axisangle: torch.Tensor,
                                   translation: torch.Tensor,
                                   invert: bool = False) -> torch.Tensor:
    """Compose axis-angle + translation into a 4x4 SE(3) transform:
    ``T(t) @ R``, or ``R^T @ T(-t)`` with ``invert``."""
    rot = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        rot = rot.transpose(1, 2)
        t = -t
    trans = translation_matrix(t)
    if invert:
        return _matmul4(rot, trans)
    return _matmul4(trans, rot)


def transform_points(transform: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """Apply (B, 4, 4) transforms to (B, 3, H, W) points in homogeneous
    coordinates, dividing by w as the reference does."""
    dtype = points.dtype
    rot = transform[:, :3, :3].to(dtype)
    trans = transform[:, :3, 3].to(dtype)
    w_row = transform[:, 3, :].to(dtype)
    out = (rot[:, :, :, None, None] * points[:, None]).sum(dim=2)
    out = out + trans[:, :, None, None]
    w = ((w_row[:, :3, None, None] * points).sum(dim=1)
         + w_row[:, 3, None, None])
    return out / w[:, None]
