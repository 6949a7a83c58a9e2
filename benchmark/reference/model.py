"""The frozen copy's configuration and modules, in a given compute type."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import configs
from benchmark.reference.codeps_ref.config import (get_cfg_defaults,
                                                   get_cfg_defaults_adapt)
from benchmark.reference.codeps_ref.models import build_modules


def reference_config(config: dict, dtype: str = "float32"):
    """The copy's config tree of ``config`` (a ``benchmark/configs`` entry)
    computing in ``dtype``."""
    base = (get_cfg_defaults_adapt() if config["defaults"] == "adapt"
            else get_cfg_defaults())
    cfg = configs.apply(base, config)
    cfg.tpu.compute_dtype = dtype
    return cfg


def build(cfg, num_classes: int, device):
    return build_modules(cfg, num_classes, device=device)


def normalized_nchw(cfg, frame: np.ndarray, device) -> torch.Tensor:
    """A uint8 (H, W, 3) frame as the normalized (1, 3, H, W) float32
    image the encoder takes."""
    norm = cfg.dataset.normalization
    mean = torch.tensor(norm.rgb_mean, dtype=torch.float32, device=device)
    std = torch.tensor(norm.rgb_std, dtype=torch.float32, device=device)
    x = torch.from_numpy(np.ascontiguousarray(frame)).to(device).float()
    return ((x / 255.0 - mean) / std).permute(2, 0, 1)[None].contiguous()
