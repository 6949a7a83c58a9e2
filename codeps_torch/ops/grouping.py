"""Pixel grouping: each pixel takes the id of its nearest offset-shifted
instance center.

Counterpart of the TPU kernel ``codeps_tpu/ops/pallas/grouping.py:65
group_pixels_pallas`` and of its plain version
``codeps_tpu/ops/panoptic.py:107 group_pixels``. For each pixel p of an
image the id is ``1 + argmin_k |(p + offset(p)) - c_k|^2`` over the valid
centers, with a strict ``<`` (ties go to the lowest k, a NaN distance
never wins) and the running argmin starting at k = 0; an image with no
valid center is all 0.

``group_pixels_cuda`` launches the hand-written kernel
(``codeps_torch/csrc/grouping.cu``), which reads the offsets as the two
planes (dy, dx) of the instance head's NCHW output; ``group_pixels_plain``
is the same function in PyTorch, used for CPU tensors and as the kernel's
check. ``group_pixels`` picks by the device of its input: the plain
version for CPU tensors, the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_MAX_CENTERS = 2048  # 12 bytes each in the kernel's 48 KB of shared memory


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


@functools.lru_cache(maxsize=None)
def _launcher():
    """``group_pixels_launch`` of the built library, with its C signature:
    four pointers, four ints, the stream; returns cudaGetLastError()."""
    from codeps_torch.ops._build import load
    fn = load("grouping").group_pixels_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def offset_planes(offsets: torch.Tensor) -> torch.Tensor:
    """The (B, 2, H, W) planes (dy, dx) of offsets (B, H, W, 2), as the
    kernel reads them.

    The instance head writes NCHW and the callers hand fusion its NHWC
    view, so the permuted tensor is already contiguous and is returned as
    it is. Any other layout (a truly NHWC tensor) is copied once, and the
    copy is counted in ``group_pixels_cuda.copies``."""
    planes = offsets.permute(0, 3, 1, 2)
    if not planes.is_contiguous():
        planes = planes.contiguous()
        group_pixels_cuda.copies += 1
    return planes


def group_pixels_cuda(centers_yx: torch.Tensor, centers_valid: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """The kernel of ``csrc/grouping.cu`` on CUDA tensors of the shapes
    ``group_pixels_plain`` takes: centers float32 (B, K, 2) and validity
    bool (B, K), both contiguous; offsets float32 (B, H, W, 2), read in
    place when they are the NHWC view of an NCHW tensor (``offset_planes``),
    all on one card."""
    if offsets.ndim != 4 or offsets.shape[-1] != 2:
        raise ValueError(f"offsets must be (B, H, W, 2), got {offsets.shape}")
    batch, height, width, _ = offsets.shape
    if centers_yx.ndim != 3 or centers_yx.shape[0] != batch \
            or centers_yx.shape[2] != 2:
        raise ValueError(f"centers must be ({batch}, K, 2), "
                         f"got {tuple(centers_yx.shape)}")
    k = centers_yx.shape[1]
    if tuple(centers_valid.shape) != (batch, k):
        raise ValueError(f"valid must be ({batch}, {k}), "
                         f"got {tuple(centers_valid.shape)}")
    if k > _MAX_CENTERS:
        raise ValueError(f"at most {_MAX_CENTERS} centers, got {k}")
    for name, tensor, dtype in (("centers", centers_yx, torch.float32),
                                ("valid", centers_valid, torch.bool),
                                ("offsets", offsets, torch.float32)):
        if tensor.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if offsets.device.type != "cuda":
        raise ValueError(f"group_pixels_cuda takes CUDA tensors, got "
                         f"offsets on {offsets.device}")
    for name, tensor in (("centers", centers_yx), ("valid", centers_valid)):
        if tensor.device != offsets.device:
            raise ValueError(f"{name} must lie on {offsets.device}, "
                             f"got {tensor.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    out = torch.empty((batch, height, width), dtype=torch.int32,
                      device=offsets.device)
    if out.numel() == 0:
        return out
    planes = offset_planes(offsets)
    with torch.cuda.device(offsets.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(centers_yx.data_ptr(), centers_valid.data_ptr(),
                          planes.data_ptr(), out.data_ptr(), batch, k,
                          height, width, stream)
    if err != 0:
        raise RuntimeError(f"group_pixels kernel launch failed: CUDA error "
                           f"{err}")
    group_pixels_cuda.launches += 1
    return out


group_pixels_cuda.launches = 0
group_pixels_cuda.copies = 0


def group_pixels(centers_yx: torch.Tensor, centers_valid: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Ids for one image ((K, 2), (K,), (H, W, 2) -> (H, W)) or a batch
    ((B, K, 2), (B, K), (B, H, W, 2) -> (B, H, W)). CPU tensors take the
    plain version; CUDA tensors take the kernel, which raises on what it
    does not take."""
    single = offsets.ndim == 3
    if single:
        centers_yx, centers_valid, offsets = (
            centers_yx[None], centers_valid[None], offsets[None])
    if offsets.device.type == "cpu":
        out = group_pixels_plain(centers_yx, centers_valid, offsets)
    else:
        out = group_pixels_cuda(centers_yx.contiguous(),
                                centers_valid.contiguous(), offsets)
    return out[0] if single else out
