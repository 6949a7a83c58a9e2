"""Resizing of NHWC images with ``F.interpolate``.

Counterpart of ``codeps_tpu/ops/resize.py:57-106``, which writes torch's
sampling rules as small interpolation matrices; here they are torch's own
(bilinear without antialiasing, both ``align_corners``; nearest 2x). The
general nearest resize picks source index ``floor(dst * in / out)``,
clamped, in integer arithmetic: the JAX package's rule, which torch's
``"nearest"`` computes through a float scale.

Inside a row split (``parallel/spatial.py``) an NCHW input is this rank's
slab of rows and ``size`` the slab of the output: the bilinear and the
general nearest resize take each output row's source rows from the
global coordinates, with the neighbouring slabs' rows they reach as a
halo; the 2x nearest upsampling of an aligned slab needs none.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from codeps_torch.parallel import spatial


def _source_rows(in_rows: int, out_rows: int, mode: str,
                 align_corners: bool):
    """Per global output row: (first source row, second source row, the
    second's weight), float64, by torch's rules (bilinear without
    antialiasing; nearest ``floor(dst * in / out)``, clamped)."""
    dst = np.arange(out_rows, dtype=np.float64)
    if mode == "nearest":
        rows = np.minimum(np.arange(out_rows) * in_rows // out_rows,
                          in_rows - 1)
        return rows, rows, np.zeros(out_rows)
    if align_corners:
        scale = (in_rows - 1) / (out_rows - 1) if out_rows > 1 else 0.0
        src = dst * scale
    else:
        src = np.maximum((dst + 0.5) * (in_rows / out_rows) - 0.5, 0.0)
    first = np.minimum(np.floor(src).astype(np.int64), in_rows - 1)
    second = np.minimum(first + 1, in_rows - 1)
    return first, second, src - first


def _resize_rows(x: torch.Tensor, out_rows: int, mode: str,
                 align_corners: bool) -> torch.Tensor:
    """The rows axis (-2) of this rank's slab ``x`` resized to its slab of
    ``out_rows`` output rows."""
    height, ranks, rank = x.shape[-2], spatial.count(), spatial.index()
    first, second, weight = _source_rows(height * ranks, out_rows * ranks,
                                         mode, align_corners)
    # one halo for every rank: the rows any slab reaches past its own
    per_out = np.arange(ranks * out_rows).reshape(ranks, out_rows)
    starts = np.arange(ranks)[:, None] * height
    top = int(max(0, (starts[:, 0] - first[per_out].min(axis=1)).max()))
    bottom = int(max(0, (second[per_out].max(axis=1) - starts[:, 0]
                         - height + 1).max()))
    ext = spatial.halo_rows(x, top, bottom, "replicate")
    mine = per_out[rank]
    base = rank * height - top
    pick = [torch.from_numpy(rows[mine] - base).to(x.device)
            for rows in (first, second)]
    lower = ext.index_select(-2, pick[0])
    if mode == "nearest":
        return lower
    upper = ext.index_select(-2, pick[1])
    lam = torch.from_numpy(weight[mine]).to(x.device, x.dtype)[:, None]
    return (1.0 - lam) * lower + lam * upper


def resize_bilinear_nchw(x: torch.Tensor, size: tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (B, C, size[0], size[1])."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if spatial.active():
        # in float32 at least, rounded once to the input's type, as
        # torch's kernel rounds its bfloat16 output
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        wide = F.interpolate(wide, size=(x.shape[-2], size[1]),
                             mode="bilinear", align_corners=align_corners,
                             antialias=False)
        return _resize_rows(wide, size[0], "bilinear",
                            align_corners).to(x.dtype)
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
    if spatial.active():
        return _resize_rows(x[..., index(width, size[1])], size[0],
                            "nearest", False)
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

