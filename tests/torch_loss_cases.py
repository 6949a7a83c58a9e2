"""Sizes, tolerances and layout helpers shared by
``tests/test_torch_losses*.py``."""

import numpy as np
import torch

B, H, W, C = 2, 32, 64, 14
REL = 1e-5
GRAD_REL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _close(ours, ref, rel, what=""):
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                      else ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = rel * float(np.abs(ref).max())
    assert err <= bound, f"{what}: {err:.3g} > {bound:.3g}"
