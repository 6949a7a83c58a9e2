"""Image sampling: the view-synthesis warp and the mixup camera warp.

``grid_sample`` is the counterpart of the plain function of
``codeps_tpu/ops/grid_sample.py:33``: ``F.grid_sample`` with
``align_corners=True``, the reference's warper call.

``prewarp_host`` and ``grid_sample_pair_pre`` are the counterparts of the
mixup camera-to-camera warp (``grid_sample.py:142-235``). The tap anchors
are integers decided on the host in float64 and the weights float32, so
the device never re-derives a tap from float32 coordinates (at exactly
integer coordinates that picks the wrong tap). The JAX package's packed
single-gather layout is a TPU rewrite; here the four taps are plain
gathers at those anchors, with the same per-tap multiply order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear",
                padding_mode: str = "border") -> torch.Tensor:
    """Sample (B, C, H, W) ``img`` at (B, Ho, Wo, 2) normalized (u, v)
    coordinates in [-1, 1]; returns (B, C, Ho, Wo)."""
    return F.grid_sample(img, grid.to(img.dtype), mode=mode,
                         padding_mode=padding_mode, align_corners=True)


def prewarp_host(x, y, height: int, width: int) -> Dict[str, np.ndarray]:
    """Taps and weights of a warp, computed on the host in float64.

    Args:
      x, y: (B, Ho, Wo) pixel coordinates into the sampled (height, width)
        image (pixel centers at integers).
    Returns:
      numpy arrays: int32 anchors ``ii``/``jj`` = clip(floor, -1, size-1)
      + 1 (the tap pair is original columns ii-1 and ii, clamped); float32
      weights ``wx``/``wy``; per-tap inside masks ``in_x0``/``in_x1``/
      ``in_y0``/``in_y1`` (bilinear with zeros padding); nearest-tap
      selectors ``sel_x0``/``sel_y0`` (round half to even, clamped: border
      padding); ``nn_inside``, whether the unclamped nearest pixel lies in
      the image.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x0 = np.floor(x)
    y0 = np.floor(y)
    rx = np.rint(x)
    ry = np.rint(y)
    ii = (np.clip(x0, -1, width - 1) + 1).astype(np.int32)
    jj = (np.clip(y0, -1, height - 1) + 1).astype(np.int32)
    rxc = np.clip(rx, 0, width - 1)
    ryc = np.clip(ry, 0, height - 1)
    return {
        "ii": ii,
        "jj": jj,
        "wx": (x - x0).astype(np.float32),
        "wy": (y - y0).astype(np.float32),
        "in_x0": (x0 >= 0) & (x0 <= width - 1),
        "in_x1": (x0 + 1 >= 0) & (x0 + 1 <= width - 1),
        "in_y0": (y0 >= 0) & (y0 <= height - 1),
        "in_y1": (y0 + 1 >= 0) & (y0 + 1 <= height - 1),
        "sel_x0": np.maximum(ii - 1, 0) == rxc,
        "sel_y0": np.maximum(jj - 1, 0) == ryc,
        "nn_inside": ((rx >= 0) & (rx <= width - 1)
                      & (ry >= 0) & (ry <= height - 1)),
    }


def grid_sample_pair_pre(img_lin: torch.Tensor, img_nn: torch.Tensor,
                         pre: Dict[str, torch.Tensor]):
    """Two samplings of one warp from ``prewarp_host``'s taps (as tensors
    on the images' device): ``img_lin`` (B, H, W, Cl) bilinear with zeros
    padding and ``img_nn`` (B, H, W, Cn) nearest with border padding.
    Returns (B, Ho, Wo, Cl) and (B, Ho, Wo, Cn) in the inputs' dtypes."""
    batch, height, width, _ = img_lin.shape
    ii = pre["ii"].long()
    jj = pre["jj"].long()
    col = ((ii - 1).clamp(min=0), ii.clamp(max=width - 1))
    row = ((jj - 1).clamp(min=0), jj.clamp(max=height - 1))
    base = torch.arange(batch, device=img_lin.device).view(batch, 1, 1) \
        * (height * width)

    def tap(img, r, c):
        flat = img.reshape(batch * height * width, img.shape[-1])
        return flat[base + r * width + c]

    wx = pre["wx"][..., None]
    wy = pre["wy"][..., None]
    vals = 0.0
    for r, c, in_y, in_x, wgt_y, wgt_x in (
            (0, 0, "in_y0", "in_x0", 1.0 - wy, 1.0 - wx),
            (0, 1, "in_y0", "in_x1", 1.0 - wy, wx),
            (1, 0, "in_y1", "in_x0", wy, 1.0 - wx),
            (1, 1, "in_y1", "in_x1", wy, wx)):
        inside = (pre[in_y] & pre[in_x])[..., None].to(img_lin.dtype)
        vals = vals + tap(img_lin, row[r], col[c]) * wgt_x * wgt_y * inside

    r = torch.where(pre["sel_y0"], row[0], row[1])
    c = torch.where(pre["sel_x0"], col[0], col[1])
    return vals, tap(img_nn, r, c)
