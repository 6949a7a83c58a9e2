"""The numpy jitter against Pillow's, the other factors; Pillow's HSV
conversions; frames sent as uint8 (``tests/test_torch_data.py`` says
more)."""

import numpy as np
import pytest
from PIL import Image

from codeps_torch.config import gen_config
from codeps_torch.data import preprocessing
from torch_data_cases import HUE_TOL, JITTER, _image, check_enhance


@pytest.mark.parametrize("name,factor", JITTER[11:])
def test_enhance_matches_pillow(name, factor):
    check_enhance(name, factor)


def test_hsv_conversions_match_pillow_everywhere():
    """Every RGB triple (a 1/3 x 1/5 x 1 grid of them) through Pillow's
    RGB -> HSV, and every (h, s) pair with a range of v back."""
    grid = np.stack(np.meshgrid(np.arange(0, 256, 3), np.arange(0, 256, 5),
                                np.arange(256), indexing="ij"), -1)
    rgb = grid.reshape(-1, 1, 3).astype(np.uint8)
    np.testing.assert_array_equal(
        preprocessing.rgb_to_hsv(rgb),
        np.asarray(Image.fromarray(rgb).convert("HSV")))
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                np.arange(0, 256, 9), indexing="ij"), -1)
    hsv = grid.reshape(-1, 1, 3).astype(np.uint8)
    ref = np.asarray(Image.fromarray(hsv, "HSV").convert("RGB"))
    assert np.abs(preprocessing.hsv_to_rgb(hsv).astype(int) - ref).max() \
        <= HUE_TOL


def test_uint8_transfer_normalizes_as_the_host_does():
    """Frames sent as uint8 (``normalization.uint8_transfer``) and
    normalized by the steps (``ops/normalize.maybe_normalize``) equal the
    host's float frames bit for bit: the same float32 operations."""
    import torch
    from codeps_torch.ops.normalize import maybe_normalize
    norm = gen_config(adapt=True, freeze=False).dataset.normalization
    img = _image(30, 64, 96)
    host = {"rgb": {0: img}}
    preprocessing.prepare_for_network(host, norm)
    norm.uint8_transfer = True
    sent = {"rgb": {0: img}}
    preprocessing.prepare_for_network(sent, norm)
    assert sent["rgb"][0].dtype == np.uint8
    on_device = maybe_normalize(torch.from_numpy(sent["rgb"][0]),
                                tuple(norm.rgb_mean), tuple(norm.rgb_std))
    np.testing.assert_array_equal(on_device.numpy(), host["rgb"][0])
