"""The port's data layer against ``codeps_tpu``'s: center/offset ground
truth, the numpy color jitter against the PIL one, flips, histogram
matching, the low-contrast check, the synthetic trees, the KITTI-360,
Cityscapes and SemKITTI-DVPS readers, and the loader's batches.

Tolerances: exact everywhere, but the hue jitter, which may differ by 1
(one level of a uint8 channel): Pillow's HSV conversions mix float and
double arithmetic, reproduced here operation by operation (seen: exact).

The tests are split over ``tests/test_torch_data*.py`` (under 13 a
file), with their shared inputs in ``tests/torch_data_cases.py``.
"""

import random

import numpy as np
import pytest
from PIL import Image

from codeps_tpu.data import dataset as jdataset
from codeps_tpu.data import preprocessing as jprep

from codeps_torch.data import dataset, preprocessing
from torch_data_cases import HUE_TOL, _augmentation, _image, _instances


@pytest.mark.parametrize("sigma", [8, 4])
def test_get_offset_center_exact(sigma):
    instance = _instances(sigma)
    ref = jdataset.get_offset_center(instance, sigma)
    ours = dataset.get_offset_center(instance, sigma)
    for r, o in zip(ref, ours):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(dataset.make_center_gaussian(sigma),
                                  jdataset.make_center_gaussian(sigma))


@pytest.mark.parametrize("seed", range(4))
def test_augment_data_matches(seed):
    rng = np.random.default_rng(seed)
    frames = {o: _image(seed * 3 + i) for i, o in enumerate((0, -1, 1))}
    offset = rng.normal(0, 3, (37, 53, 2)).astype(np.float32)
    semantic = rng.integers(0, 14, (37, 53)).astype(np.uint8)
    camera = np.asarray([40.0, 40.0, 20.5, 18.0], np.float32)

    def sample(as_pil):
        return {"rgb": {o: Image.fromarray(f) if as_pil else f.copy()
                        for o, f in frames.items()},
                "camera_model": camera.copy(), "offset": offset.copy(),
                "semantic": semantic.copy()}

    ref, ours = sample(True), sample(False)
    jprep.augment_data(ref, _augmentation(True), rng=random.Random(seed))
    preprocessing.augment_data(ours, _augmentation(True),
                               random.Random(seed))
    for o in frames:
        assert np.abs(ours["rgb"][o].astype(int)
                      - np.asarray(ref["rgb"][o])).max() <= HUE_TOL
    for key in ("camera_model", "offset", "semantic"):
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_flip_mirrors_camera_and_offsets():
    """A seed whose draw flips: the image is mirrored, cx becomes W - cx - 1
    and the offsets' x channel changes sign."""
    cfg = _augmentation(True)
    for key in ("brightness_jitter", "contrast_jitter", "saturation_jitter",
                "hue_jitter"):
        cfg[key] = None
    seed = next(s for s in range(100) if random.Random(s).random() > 0.5)
    img = _image(5)
    offset = np.random.default_rng(0).normal(0, 3, (37, 53, 2)).astype(
        np.float32)
    sample = {"rgb": {0: img}, "camera_model": np.asarray(
        [40.0, 40.0, 20.5, 18.0], np.float32), "offset": offset}
    preprocessing.augment_data(sample, cfg, random.Random(seed))
    np.testing.assert_array_equal(sample["rgb"][0], img[:, ::-1])
    assert sample["camera_model"][2] == 53 - 20.5 - 1
    np.testing.assert_array_equal(sample["offset"][..., 1],
                                  -offset[:, ::-1, 1])
    np.testing.assert_array_equal(sample["offset"][..., 0],
                                  offset[:, ::-1, 0])


def test_histogram_matching_and_style_transfer():
    src, ref_img = _image(20, 64, 80), _image(21, 40, 50) // 2
    np.testing.assert_array_equal(
        preprocessing.match_histograms(src, ref_img),
        jprep.match_histograms(src, ref_img))
    np.testing.assert_array_equal(
        preprocessing.transfer_histogram_style(src, ref_img, "rgb"),
        np.asarray(jprep.transfer_histogram_style(
            Image.fromarray(src), Image.fromarray(ref_img), "rgb")))
    assert preprocessing.transfer_histogram_style(src, ref_img, None) is src


@pytest.mark.parametrize("spread", [4, 30, 60, 255])
def test_is_low_contrast_matches(spread):
    rng = np.random.default_rng(spread)
    img = (rng.integers(0, spread + 1, (30, 40, 3)) + 100 - spread // 2)
    img = img.clip(0, 255).astype(np.uint8)
    for args in ({}, {"fraction_threshold": 0.2, "lower_percentile": 10,
                      "upper_percentile": 90}):
        assert preprocessing.is_low_contrast(img, **args) \
            == jprep.is_low_contrast(img, **args)
        assert preprocessing.is_low_contrast(img[..., 0], **args) \
            == jprep.is_low_contrast(img[..., 0], **args)
