"""Device selection shared by the entry points, and device constants."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA device without a visible card raises; nothing falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The numbers ``values`` as a 1-D tensor of ``dtype`` on ``device``,
    made (copied from the host) on the first call with these arguments
    and kept: a later call copies nothing, so it may run inside a CUDA
    graph's capture. The tensor is shared; nothing may write into it."""
    return _constant(tuple(float(v) for v in values), dtype,
                     torch.device(device))
