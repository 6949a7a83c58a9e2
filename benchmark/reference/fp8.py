"""Emulated float8 for the control: every convolution and matrix product
of the reference takes its two operands rounded to ``float8_e4m3fn`` with a
per-tensor scale (the largest magnitude at 448, as float8 training scales
them), the result and everything else in float32. The rounding passes its
gradient straight through, so the backward runs on the rounded operands.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_PRODUCTS = {torch.conv2d, F.conv2d, torch.conv_transpose2d, F.linear,
             torch.matmul, torch.mm, torch.bmm}


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = E4M3_MAX / x.detach().abs().amax().float().clamp_min(1e-30)
    rounded = (x.detach().float() * scale).to(torch.float8_e4m3fn) \
        .float().div(scale).to(x.dtype)
    return x + (rounded - x).detach()


class Fp8Products(TorchFunctionMode):

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(to_fp8(a) if i < 2 and isinstance(a, torch.Tensor)
                         and a.is_floating_point() else a
                         for i, a in enumerate(args))
        return func(*args, **kwargs)


def precision(name: str):
    """The context of the reference's ``name`` precision: ``float32``
    (TF32 off) or ``fp8``."""
    from benchmark.weights import no_tf32
    stack = contextlib.ExitStack()
    stack.enter_context(no_tf32())
    if name == "fp8":
        stack.enter_context(Fp8Products())
    elif name != "float32":
        raise ValueError(f"unknown precision {name!r}")
    return stack
