"""Pixel grouping: each pixel takes the id of its nearest offset-shifted
instance center.

The benchmark's frozen copy: ``group_pixels`` is the plain PyTorch version
on every device (the copied package builds no kernel). For each pixel p of
an image the id is ``1 + argmin_k |(p + offset(p)) - c_k|^2`` over the
valid centers, with a strict ``<`` (ties go to the lowest k, a NaN
distance never wins); an image with no valid center is all 0.
"""

from __future__ import annotations

import torch


def group_pixels_plain(centers_yx: torch.Tensor, centers_valid: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int32 ids from centers (B, K, 2) as (y, x), their
    validity (B, K) and offsets (B, H, W, 2) as (dy, dx).

    Walks the centers one by one with a running (min, argmin), NaN
    distances mapped to +inf as in ``codeps_tpu/ops/panoptic.py:150``.
    """
    batch, height, width, _ = offsets.shape
    k = centers_yx.shape[1]
    device = offsets.device
    offsets = offsets.to(torch.float32)
    y_coord = torch.arange(height, dtype=torch.float32, device=device)
    x_coord = torch.arange(width, dtype=torch.float32, device=device)
    loc_y = (y_coord[None, :, None] + offsets[..., 0]).reshape(batch, -1)
    loc_x = (x_coord[None, None, :] + offsets[..., 1]).reshape(batch, -1)
    inf = torch.tensor(float("inf"), device=device)
    ctr_y = torch.where(centers_valid, centers_yx[..., 0].float(), inf)
    ctr_x = torch.where(centers_valid, centers_yx[..., 1].float(), inf)

    best_dist = torch.full_like(loc_y, float("inf"))
    best_id = torch.zeros(loc_y.shape, dtype=torch.int32, device=device)
    for i in range(k):
        dy = loc_y - ctr_y[:, i:i + 1]
        dx = loc_x - ctr_x[:, i:i + 1]
        dist = dy * dy + dx * dx
        dist = torch.where(torch.isnan(dist), inf, dist)
        take = dist < best_dist
        best_dist = torch.where(take, dist, best_dist)
        best_id = torch.where(take, i, best_id)
    instance = (best_id + 1).reshape(batch, height, width)
    any_valid = centers_valid.any(dim=1)[:, None, None]
    return torch.where(any_valid, instance, 0).to(torch.int32)


def group_pixels(centers_yx: torch.Tensor, centers_valid: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Ids for one image ((K, 2), (K,), (H, W, 2) -> (H, W)) or a batch
    ((B, K, 2), (B, K), (B, H, W, 2) -> (B, H, W))."""
    single = offsets.ndim == 3
    if single:
        centers_yx, centers_valid, offsets = (
            centers_yx[None], centers_valid[None], offsets[None])
    out = group_pixels_plain(centers_yx, centers_valid, offsets)
    return out[0] if single else out
