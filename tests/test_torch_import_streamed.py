"""The rest of the streamed path's modules import no PIL, cv2, YAML or
JAX (``tests/test_torch_import.py`` says more)."""

import pytest

from torch_import_cases import STREAM_MODULES, check_streamed_import


@pytest.mark.parametrize("module", STREAM_MODULES[7:])
def test_streamed_path_imports_no_pil_cv2_or_yaml(module):
    check_streamed_import(module)
