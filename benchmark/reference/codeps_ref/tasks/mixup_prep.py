"""Mixup preparation: the camera-to-camera warp.

Counterpart of ``codeps_tpu/tasks/mixup_prep.py``'s ``c2c_prewarp``: the
unit-depth reprojection in float64 on the host, turned into the taps and
weights of ``ops/grid_sample.grid_sample_pair_pre``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.reference.codeps_ref.ops.grid_sample import grid_sample_pair_pre, prewarp_host


def c2c_prewarp(intr_sampled, intr_out, sampled_size: tuple[int, int],
                out_size: tuple[int, int]) -> Dict[str, np.ndarray]:
    """Taps that warp an image of camera ``intr_sampled`` (B, 4) fx, fy,
    cx, cy at ``sampled_size`` (H, W) onto the lattice of camera
    ``intr_out`` (B, 4) at ``out_size``."""
    intr_sampled = np.asarray(intr_sampled, np.float64)
    intr_out = np.asarray(intr_out, np.float64)
    out_h, out_w = out_size
    src_h, src_w = sampled_size
    u = np.arange(out_w, dtype=np.float64)[None, None, :]
    v = np.arange(out_h, dtype=np.float64)[None, :, None]
    fx_o, fy_o = intr_out[:, 0, None, None], intr_out[:, 1, None, None]
    cx_o, cy_o = intr_out[:, 2, None, None], intr_out[:, 3, None, None]
    fx_s, fy_s = (intr_sampled[:, 0, None, None],
                  intr_sampled[:, 1, None, None])
    cx_s, cy_s = (intr_sampled[:, 2, None, None],
                  intr_sampled[:, 3, None, None])
    x = np.broadcast_to((u - cx_o) / fx_o * fx_s + cx_s,
                        (intr_out.shape[0], out_h, out_w))
    y = np.broadcast_to((v - cy_o) / fy_o * fy_s + cy_s,
                        (intr_out.shape[0], out_h, out_w))
    return prewarp_host(x, y, src_h, src_w)
