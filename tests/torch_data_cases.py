"""Inputs and checks shared by ``tests/test_torch_data*.py``: images,
instance maps, the jitter factors, the augmentation config, the synthetic
trees of both packages and the comparison of reader samples."""

import numpy as np
import pytest
from PIL import Image

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.data import preprocessing as jprep
from codeps_tpu.data import synthetic as jsynthetic

from codeps_torch.config import gen_config
from codeps_torch.data import preprocessing, synthetic

HUE_TOL = 1


def _image(seed, height=37, width=53):
    return np.random.default_rng(seed).integers(0, 256, (height, width, 3),
                                                dtype=np.uint8)


def _instances(seed, height=48, width=64):
    rng = np.random.default_rng(seed)
    out = np.zeros((height, width), np.int32)
    for i in range(5):
        y, x = rng.integers(0, height - 4), rng.integers(0, width - 4)
        out[y:y + rng.integers(2, 20), x:x + rng.integers(2, 30)] = \
            (11 + i % 2) * 1000 + i
    out[0:3, -3:] = 13000          # touches the border
    return out


JITTER = [(name, factor) for name in ("brightness", "contrast",
                                      "saturation")
          for factor in (0.0, 0.8, 0.97, 1.0, 1.13, 1.2, 1.6)]


def check_enhance(name, factor):
    img = _image(0)
    ref = np.asarray(getattr(jprep, f"adjust_{name}")(Image.fromarray(img),
                                                      factor))
    ours = getattr(preprocessing, f"adjust_{name}")(img, factor)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


def _augmentation(flip):
    cfg = gen_config(adapt=True, freeze=False).dataset.augmentation
    cfg.horizontal_flipping = flip
    return cfg


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_data")
    return {"cs": synthetic.make_cityscapes_tree(tmp / "cs", num_frames=3),
            "k360": synthetic.make_kitti360_tree(tmp / "k360",
                                                 num_frames=4),
            "cs_jax": jsynthetic.make_cityscapes_tree(tmp / "cs_jax",
                                                      num_frames=3),
            "k360_jax": jsynthetic.make_kitti360_tree(tmp / "k360_jax",
                                                      num_frames=4),
            "sk": synthetic.make_semkitti_tree(tmp / "sk", num_frames=4),
            "sk_jax": jsynthetic.make_semkitti_tree(tmp / "sk_jax",
                                                    num_frames=4)}


def _cfgs(trees, name):
    out = []
    for make in (jax_gen_config, gen_config):
        cfg = make(adapt=True, freeze=False)
        if name == "kitti_360":
            cfg.dataset.name = "kitti_360"
            cfg.dataset.path = str(trees["k360"])
            cfg.dataset.feed_img_size = [32, 48]
        elif name == "sem_kitti_dvps":
            cfg.dataset.name = "sem_kitti_dvps"
            cfg.dataset.path = str(trees["sk"])
            cfg.dataset.feed_img_size = [32, 48]
        else:
            cfg.dataset.name = "cityscapes"
            cfg.dataset.path = str(trees["cs"])
            cfg.dataset.feed_img_size = [32, 64]
        cfg.dataset.center_heatmap_sigma = 4
        cfg.dataset.augmentation.horizontal_flipping = True
        out.append(cfg)
    return out


def _assert_samples_equal(ours, ref):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if key == "rgb":
            assert set(ours["rgb"]) == set(value)
            for o, img in value.items():
                img = np.asarray(img)
                assert ours["rgb"][o].dtype == img.dtype, o
                assert np.abs(ours["rgb"][o].astype(np.float64)
                              - img).max() <= (HUE_TOL if img.dtype
                                               == np.uint8 else 1e-5), o
        else:
            assert ours[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
