"""The compute dtype of the modules, ``cfg.tpu.compute_dtype``.

Counterpart of the ``dtype=`` of the JAX package's Flax modules
(``codeps_tpu/models/codeps_net.py:49 build_modules``, chosen from the
config by ``scripts/{train,adapt}.py``): with ``"bfloat16"`` the
convolutions of the encoders and heads run in bfloat16 while parameters,
BatchNorm statistics, optimizer state and every head's full-resolution
output stay float32; ``"float32"`` is the exact mode. A module runs its
body under ``torch.autocast`` in its own ``compute_dtype``.

Modules and inputs cast to float64 (``.double()``, the tests' exactness
mode) stay float64 throughout: where the float32 paths widen an output or
a loss's arithmetic to float32 (``widened``, ``loss_dtype``), float64 is
kept.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """The torch dtype that ``cfg.tpu.compute_dtype`` names."""
    name = cfg.tpu.compute_dtype
    if name not in _DTYPES:
        raise ValueError(f"tpu.compute_dtype must be one of "
                         f"{sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


class ComputeDtype:
    """Mixin of a module that runs in ``compute_dtype`` (float32 unless
    ``build_modules`` sets it)."""

    compute_dtype: torch.dtype = torch.float32

    def autocast(self, x: torch.Tensor):
        """The autocast context of the module's body for input ``x``: on
        in bfloat16, off (exact float32) otherwise."""
        return torch.autocast(x.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == torch.bfloat16)


def widened(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in float64 if it is float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def loss_dtype(dtype: torch.dtype, x: torch.Tensor) -> torch.dtype:
    """A loss's arithmetic type: ``dtype`` (the config's compute dtype),
    or float64 for a float64 ``x``."""
    return torch.float64 if x.dtype == torch.float64 else dtype
