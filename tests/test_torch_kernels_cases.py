"""The grouping kernel against its plain version on the card, cases 6-11
(``tests/test_torch_kernels.py`` says how they run)."""

import pytest

from torch_kernel_cases import (CASE_NAMES, check_matches_plain)
from torch_kernel_cases import few_threads  # noqa: F401 (autouse)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
@pytest.mark.parametrize("case", CASE_NAMES[5:11])
def test_group_pixels_cuda_matches_plain(case, layout):
    check_matches_plain(case, layout)
