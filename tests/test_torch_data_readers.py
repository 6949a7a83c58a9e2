"""The synthetic trees and the KITTI-360, Cityscapes and SemKITTI-DVPS
readers against the JAX package's (``tests/test_torch_data.py`` says
more)."""

import random

import numpy as np
import pytest

from codeps_tpu.data import Cityscapes as JaxCityscapes
from codeps_tpu.data import Kitti360 as JaxKitti360
from codeps_tpu.data import SemKittiDvps as JaxSemKittiDvps

from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.kitti_360 import Kitti360
from codeps_torch.data.sem_kitti_dvps import SemKittiDvps
from torch_data_cases import _assert_samples_equal, _cfgs
from torch_data_cases import trees  # noqa: F401 (fixture)


def test_synthetic_trees_match(trees):
    for ours_root, ref_root in ((trees["cs"], trees["cs_jax"]),
                                (trees["k360"], trees["k360_jax"]),
                                (trees["sk"], trees["sk_jax"])):
        ours = sorted(p.relative_to(ours_root) for p in ours_root.rglob("*")
                      if p.is_file())
        ref = sorted(p.relative_to(ref_root) for p in ref_root.rglob("*")
                     if p.is_file())
        assert ours == ref
        for rel in ours:
            assert (ours_root / rel).read_bytes() \
                == (ref_root / rel).read_bytes(), rel


@pytest.mark.parametrize("augment", [False, True])
def test_kitti360_reader_matches(trees, augment):
    jcfg, pcfg = _cfgs(trees, "kitti_360")
    ref_ds = JaxKitti360("sequence", jcfg.dataset, return_depth=True,
                         sequences=["03"])
    ours_ds = Kitti360("sequence", pcfg.dataset, return_depth=True,
                       sequences=["03"])
    assert len(ours_ds) == len(ref_ds) > 0
    np.testing.assert_array_equal(ours_ds.camera_model, ref_ds.camera_model)
    for index in range(len(ref_ds)):
        random.seed(index)
        ref = ref_ds.__getitem__(index, do_augmentation=augment,
                                 do_network_preparation=augment)
        ours = ours_ds.__getitem__(index, do_augmentation=augment,
                                   do_network_preparation=augment,
                                   rng=random.Random(index))
        if not augment:
            ref["rgb"] = {o: np.asarray(v) for o, v in ref["rgb"].items()}
        _assert_samples_equal(ours, ref)


@pytest.mark.parametrize("augment", [False, True])
def test_cityscapes_reader_matches(trees, augment):
    jcfg, pcfg = _cfgs(trees, "cityscapes")
    ref_ds = JaxCityscapes("train", jcfg.dataset, return_depth=True)
    ours_ds = Cityscapes("train", pcfg.dataset, return_depth=True)
    assert len(ours_ds) == len(ref_ds) > 0
    for index in range(len(ref_ds)):
        random.seed(index)
        ref = ref_ds.__getitem__(index, do_augmentation=augment,
                                 do_network_preparation=augment)
        ours = ours_ds.__getitem__(index, do_augmentation=augment,
                                   do_network_preparation=augment,
                                   rng=random.Random(index))
        if not augment:
            ref["rgb"] = {o: np.asarray(v) for o, v in ref["rgb"].items()}
        _assert_samples_equal(ours, ref)


@pytest.mark.parametrize("only_rgb", [False, True])
def test_cityscapes_pretraining_items_match(trees, only_rgb):
    """The pretraining CLI's train reader, augmented: without depth, and
    only RGB for cfg/train_cityscapes_depth_only.yaml."""
    jcfg, pcfg = _cfgs(trees, "cityscapes")
    ref_ds = JaxCityscapes("train", jcfg.dataset, return_only_rgb=only_rgb)
    ours_ds = Cityscapes("train", pcfg.dataset, return_only_rgb=only_rgb)
    assert len(ours_ds) == len(ref_ds) > 0
    for index in range(len(ref_ds)):
        random.seed(index)
        ref = ref_ds.__getitem__(index, do_augmentation=True,
                                 do_network_preparation=True)
        ours = ours_ds.__getitem__(index, do_augmentation=True,
                                   do_network_preparation=True,
                                   rng=random.Random(index))
        assert "depth" not in ours
        if only_rgb:
            assert set(ours) == {"rgb", "camera_model"}
        _assert_samples_equal(ours, ref)


@pytest.mark.parametrize("label_mode", ["codeps", "cityscapes"])
@pytest.mark.parametrize("augment", [False, True])
def test_semkitti_reader_matches(trees, augment, label_mode):
    jcfg, pcfg = _cfgs(trees, "sem_kitti_dvps")
    ref_ds = JaxSemKittiDvps("sequence", jcfg.dataset, return_depth=True,
                             sequences=["07"], label_mode=label_mode)
    ours_ds = SemKittiDvps("sequence", pcfg.dataset, return_depth=True,
                           sequences=["07"], label_mode=label_mode)
    assert len(ours_ds) == len(ref_ds) > 0
    assert ours_ds.ignore_classes == ref_ds.ignore_classes
    assert ours_ds.thing_classes == ref_ds.thing_classes
    for index in range(len(ref_ds)):
        random.seed(index)
        ref = ref_ds.__getitem__(index, do_augmentation=augment,
                                 do_network_preparation=augment)
        ours = ours_ds.__getitem__(index, do_augmentation=augment,
                                   do_network_preparation=augment,
                                   rng=random.Random(index))
        if not augment:
            ref["rgb"] = {o: np.asarray(v) for o, v in ref["rgb"].items()}
        assert {"depth", "instance", "camera_model"} <= set(ours)
        assert (ours["depth"] > 0).any()
        _assert_samples_equal(ours, ref)
