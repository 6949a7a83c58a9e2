"""Differentiable image sampling for the view-synthesis warp.

Counterpart of the plain function of ``codeps_tpu/ops/grid_sample.py:33
grid_sample``: ``F.grid_sample`` with ``align_corners=True``, the
reference's warper call. Its packed-tap gathers are a TPU rewrite of the
same sampling and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear",
                padding_mode: str = "border") -> torch.Tensor:
    """Sample (B, C, H, W) ``img`` at (B, Ho, Wo, 2) normalized (u, v)
    coordinates in [-1, 1]; returns (B, C, Ho, Wo)."""
    return F.grid_sample(img, grid.to(img.dtype), mode=mode,
                         padding_mode=padding_mode, align_corners=True)
