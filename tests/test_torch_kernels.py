"""The hand-written CUDA kernels against their plain PyTorch versions.

These files (``tests/test_torch_kernels*.py``, each under 13 tests, with
their inputs in ``tests/torch_kernel_cases.py``) import no JAX, so on a
machine with a card they run without the repository's conftest (which
sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels*.py

Tests marked ``gpu`` need a card and skip where none is visible; the
kernels must equal their plain versions exactly. The others run on the
CPU: the wrapper's layout handling and its checks, which raise before
anything reaches a card.
"""

import pytest
import torch

from codeps_torch.ops import grouping
from torch_kernel_cases import (CASE_NAMES, CASES, check_matches_plain,
                               _needs_card)
from torch_kernel_cases import few_threads  # noqa: F401 (autouse)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
@pytest.mark.parametrize("case", CASE_NAMES[:5])
def test_group_pixels_cuda_matches_plain(case, layout):
    check_matches_plain(case, layout)


@pytest.mark.gpu
def test_group_pixels_cuda_unaligned_planes():
    """Planes that start 4 bytes past a 16-byte boundary take the scalar
    path."""
    _needs_card()
    yx, valid, offsets = (t.cuda() for t in CASES["random"])
    planes = offsets.permute(0, 3, 1, 2)
    buffer = torch.empty(planes.numel() + 1, device="cuda")
    buffer[1:] = planes.flatten()
    view = buffer[1:].view(planes.shape).permute(0, 2, 3, 1)
    ours = grouping.group_pixels_cuda(yx, valid, view)
    torch.cuda.synchronize()
    assert torch.equal(ours, grouping.group_pixels_plain(yx, valid, offsets))


def test_group_pixels_cuda_rejects_cpu_tensors():
    yx, valid, offsets = CASES["random"]
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        grouping.group_pixels_cuda(yx, valid, offsets)
