"""Resizing of NHWC images with ``F.interpolate``.

Counterpart of ``codeps_tpu/ops/resize.py:57-106``, which writes torch's
sampling rules as small interpolation matrices; here they are torch's own
(bilinear without antialiasing, both ``align_corners``; nearest 2x). The
general nearest resize picks source index ``floor(dst * in / out)``,
clamped, in integer arithmetic: the JAX package's rule, which torch's
``"nearest"`` computes through a float scale.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, size: tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (B, C, size[0], size[1])."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners, antialias=False)


def upsample_nearest_2x_nchw(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of (B, C, H, W)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_nearest_nchw(x: torch.Tensor,
                        size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (B, C, H, W) to (B, C, size[0], size[1])."""
    height, width = x.shape[-2:]
    if (height, width) == tuple(size):
        return x

    def index(in_size, out_size):
        dst = torch.arange(out_size, device=x.device)
        return torch.clamp(dst * in_size // out_size, max=in_size - 1)
    return x[..., index(height, size[0])[:, None], index(width, size[1])]


def resize_bilinear(img: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, H, W, C) to (B, size[0], size[1], C)."""
    out = resize_bilinear_nchw(img.permute(0, 3, 1, 2), size, align_corners)
    return out.permute(0, 2, 3, 1)


def resize_nearest(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (B, H, W, C) to (B, size[0], size[1], C)."""
    return resize_nearest_nchw(img.permute(0, 3, 1, 2), size).permute(
        0, 2, 3, 1)


def upsample_nearest_2x(img: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of (B, H, W, C)."""
    return upsample_nearest_2x_nchw(img.permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)

