"""Resizing of NHWC images with ``F.interpolate``.

Counterpart of ``codeps_tpu/ops/resize.py:57-106``, which writes torch's
sampling rules as small interpolation matrices; here they are torch's own
(bilinear without antialiasing, both ``align_corners``; nearest 2x). The
general nearest resize picks source index ``floor(dst * in / out)``,
clamped, in integer arithmetic: the JAX package's rule, which torch's
``"nearest"`` computes through a float scale.

Inside a row split (``parallel/spatial.py``) an NCHW input is this rank's
slab of rows and ``size`` the slab of the output, both levels of the
slabs of ``spatial.image``: the bilinear and the general nearest
resize take each output row's source rows from the
global coordinates, with the neighbouring slabs' rows they reach as a
halo; the 2x nearest upsampling of an aligned slab needs none. A rank
with an empty slab joins the halo's exchange and gets an empty slab.
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


def _resize_rows(x: torch.Tensor, size: tuple[int, int], mode: str,
                 align_corners: bool, columns) -> torch.Tensor:
    """This rank's slab ``x`` resized to its slab of ``size``: the slab
    with the rows its output rows reach past it (the halo, at the input's
    width), its columns resized by ``columns``, then each output row from
    its source rows (the slabs of ``spatial.slabs``)."""
    ins = spatial.slabs(x.shape[-2], x.shape[-1])
    outs = spatial.slabs(size[0], size[1])
    first, second, weight = _source_rows(sum(n for _, n in ins),
                                         sum(n for _, n in outs), mode,
                                         align_corners)
    # one halo for every rank: the rows any slab reaches past its own
    top = bottom = 0
    for (start, height), (out_start, out_height) in zip(ins, outs):
        if not out_height:
            continue
        mine = slice(out_start, out_start + out_height)
        top = max(top, start - int(first[mine].min()))
        bottom = max(bottom, int(second[mine].max()) - start - height + 1)
    ext = columns(spatial.halo_rows(x, top, bottom, "replicate"))
    out_start, out_height = outs[spatial.index()]
    mine = slice(out_start, out_start + out_height)
    base = ins[spatial.index()][0] - top
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
        def interpolate(rows):
            return F.interpolate(rows, size=(rows.shape[-2], size[1]),
                                 mode="bilinear",
                                 align_corners=align_corners,
                                 antialias=False)

        def columns(rows):
            return interpolate(rows) if rows.shape[-2] else \
                spatial.on_empty(interpolate, rows)
        wide = x.to(torch.promote_types(x.dtype, torch.float32))
        return _resize_rows(wide, size, "bilinear", align_corners,
                            columns).to(x.dtype)
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners, antialias=False)


def upsample_nearest_2x_nchw(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of (B, C, H, W)."""
    def upsample(rows):
        return F.interpolate(rows, scale_factor=2, mode="nearest")
    # a row split's empty slab, which torch's kernel refuses
    return upsample(x) if x.shape[-2] else spatial.on_empty(upsample, x)


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
        return _resize_rows(x, size, "nearest", False,
                            lambda rows: rows[..., index(width, size[1])])
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

