"""The loader's batches, the RGB-only readers and the class distribution
against the JAX package's (``tests/test_torch_data.py`` says more)."""

import random

import numpy as np

from codeps_tpu.data import Cityscapes as JaxCityscapes
from codeps_tpu.data import DataLoader as JaxDataLoader
from codeps_tpu.data import Kitti360 as JaxKitti360

from codeps_torch.data import dataset
from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.kitti_360 import Kitti360
from codeps_torch.data.loader import DataLoader, collate_batch
from torch_data_cases import _cfgs
from torch_data_cases import trees  # noqa: F401 (fixture)


def test_loader_batches_match(trees):
    """One seed, shuffled, augmented Cityscapes batches: the threaded
    path and the worker processes give the JAX loader's batches."""
    jcfg, pcfg = _cfgs(trees, "cityscapes")
    ref_ds = JaxCityscapes("train", jcfg.dataset, return_depth=True)
    ours_ds = Cityscapes("train", pcfg.dataset, return_depth=True)

    def batches(loader_cls, dataset, **kwargs):
        random.seed(5)
        np.random.seed(5)
        loader = loader_cls(dataset, batch_size=2, offsets=[1], seed=3,
                            drop_last=False, **kwargs)
        return len(loader), list(loader)

    for kwargs in ({}, {"num_workers": 2},
                   {"num_shards": 2, "shard_index": 1}):
        n_ref, ref = batches(JaxDataLoader, ref_ds, **kwargs)
        n_ours, ours = batches(DataLoader, ours_ds, **kwargs)
        assert n_ours == n_ref == len(ref) == len(ours) > 0, kwargs
        for ours_batch, ref_batch in zip(ours, ref):
            assert set(ours_batch) == set(ref_batch)
            for key, value in ref_batch.items():
                assert ours_batch[key].dtype == value.dtype, key
                np.testing.assert_array_equal(ours_batch[key], value,
                                              err_msg=f"{kwargs} {key}")
    samples = [ours_ds.__getitem__(i, do_augmentation=False,
                                   do_network_preparation=False)
               for i in range(2)]
    batch = collate_batch(samples)
    assert batch["frames"].dtype == np.uint8
    assert batch["frames"].shape == (2, 3, 32, 64, 3)
    assert batch["depth_gt"].shape == (2, 32, 64)


def test_only_rgb_readers_match(trees):
    jcfg, pcfg = _cfgs(trees, "kitti_360")
    ref = JaxKitti360("sequence", jcfg.dataset, sequences=["03"])
    ours = Kitti360("sequence", pcfg.dataset, sequences=["03"])
    a = ours.__getitem__(1, do_augmentation=False,
                         do_network_preparation=False, return_only_rgb=True)
    b = ref.__getitem__(1, do_augmentation=False,
                        do_network_preparation=False, return_only_rgb=True)
    assert set(a) == set(b) == {"rgb", "camera_model"}
    for o in b["rgb"]:
        np.testing.assert_array_equal(a["rgb"][o], np.asarray(b["rgb"][o]))


def test_class_distribution_counts(trees):
    _, pcfg = _cfgs(trees, "cityscapes")
    ds = Cityscapes("train", pcfg.dataset)
    dist = dataset.class_distribution(ds)
    expect_pixels = {}
    for index in range(len(ds)):
        semantic = ds.__getitem__(index, do_augmentation=False,
                                  do_network_preparation=False)["semantic"]
        for cls, count in zip(*np.unique(semantic, return_counts=True)):
            if cls != 255:
                expect_pixels[int(cls)] = expect_pixels.get(int(cls), 0) \
                    + int(count)
                assert dist["images_num_pixels"][index][int(cls)] == count
                assert index in dist["class_images"][int(cls)]
    assert dist["num_pixels"] == expect_pixels
