"""View-synthesis warping: depth + relative pose -> resampled neighbor frame.

Counterpart of ``codeps_tpu/geometry/warp.py`` (the reference's
``ImageWarper``), NCHW: backproject the target pixels with their depth,
move them into the neighbor camera, reproject, sample with border
padding and ``align_corners=True``.
"""

from __future__ import annotations

import torch

from benchmark.reference.codeps_ref.geometry import camera as cam
from benchmark.reference.codeps_ref.geometry import pose as pose_lib
from benchmark.reference.codeps_ref.ops.grid_sample import grid_sample


def warp_coordinates(intrinsics: torch.Tensor, depth: torch.Tensor,
                     transform: torch.Tensor,
                     object_motion: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """(B, H, W, 2) normalized (u, v) sampling coordinates.

    Args:
      intrinsics: (B, 4) ``[fx, fy, cx, cy]``.
      depth: (B, 1, H, W) depth of the target frame.
      transform: (B, 4, 4) SE(3) from target-camera to neighbor-camera
        points.
      object_motion: optional (B, 3, H, W) additive scene flow.
    """
    height, width = depth.shape[-2:]
    points = cam.backproject(depth, intrinsics)
    points = pose_lib.transform_points(transform, points)
    if object_motion is not None:
        points = points + object_motion
    uv = cam.project(points, intrinsics)
    u_norm = (uv[..., 0] / (width - 1) - 0.5) * 2.0
    v_norm = (uv[..., 1] / (height - 1) - 0.5) * 2.0
    return torch.stack([u_norm, v_norm], dim=-1)


def warp_image(intrinsics: torch.Tensor, src_img: torch.Tensor,
               depth: torch.Tensor, transform: torch.Tensor,
               interp_mode: str = "bilinear",
               object_motion: torch.Tensor | None = None) -> torch.Tensor:
    """Warp (B, C, H, W) ``src_img``, a neighbor frame, into the target
    view."""
    coords = warp_coordinates(intrinsics, depth, transform, object_motion)
    return grid_sample(src_img, coords, mode=interp_mode)
