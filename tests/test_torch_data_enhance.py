"""The numpy brightness, contrast and saturation jitter against Pillow's,
the first 11 factors (``tests/test_torch_data.py`` says more)."""

import pytest

from torch_data_cases import JITTER, check_enhance


@pytest.mark.parametrize("name,factor", JITTER[:11])
def test_enhance_matches_pillow(name, factor):
    check_enhance(name, factor)
