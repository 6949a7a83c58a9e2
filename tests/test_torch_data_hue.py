"""The numpy hue jitter and the composed jitter against Pillow's
(``tests/test_torch_data.py`` says more)."""

import random

import numpy as np
import pytest
from PIL import Image

from codeps_tpu.data import preprocessing as jprep

from codeps_torch.data import preprocessing
from torch_data_cases import HUE_TOL, _image


@pytest.mark.parametrize("factor", [-0.5, -0.1, -0.03, 0.0, 0.04, 0.1, 0.5])
def test_hue_matches_pillow(factor):
    img = _image(1)
    ref = np.asarray(jprep.adjust_hue(Image.fromarray(img), factor))
    ours = preprocessing.adjust_hue(img, factor)
    assert np.abs(ours.astype(int) - ref).max() <= HUE_TOL


@pytest.mark.parametrize("seed", range(4))
def test_composed_jitter_matches_under_one_seed(seed):
    img = _image(seed + 10)
    r_ref, r_ours = random.Random(seed), random.Random(seed)
    ref = np.asarray(jprep.get_random_color_jitter(r_ref, 0.2, 0.2, 0.2,
                                                   0.1)(Image.fromarray(img)))
    ours = preprocessing.get_random_color_jitter(r_ours, 0.2, 0.2, 0.2,
                                                 0.1)(img)
    assert np.abs(ours.astype(int) - ref).max() <= HUE_TOL
    # the draws consumed the same stream
    assert r_ref.random() == r_ours.random()
