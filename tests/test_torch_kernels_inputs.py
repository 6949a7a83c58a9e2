"""The grouping wrapper's checks of its inputs, on the CPU
(``tests/test_torch_kernels.py`` says how they run)."""

import pytest

from codeps_torch.ops import grouping
from torch_kernel_cases import (BAD_INPUTS)
from torch_kernel_cases import few_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_group_pixels_cuda_rejects_bad_inputs(case):
    """Wrong shapes, types and devices raise before any launch or copy."""
    args, error, match = BAD_INPUTS[case]
    launches = grouping.group_pixels_cuda.launches
    copies = grouping.group_pixels_cuda.copies
    with pytest.raises(error, match=match):
        grouping.group_pixels_cuda(*args)
    assert grouping.group_pixels_cuda.launches == launches
    assert grouping.group_pixels_cuda.copies == copies
