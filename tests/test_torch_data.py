"""The port's data layer against ``codeps_tpu``'s: center/offset ground
truth, the numpy color jitter against the PIL one, flips, histogram
matching, the low-contrast check, the synthetic trees, the KITTI-360,
Cityscapes and SemKITTI-DVPS readers, and the loader's batches.

Tolerances: exact everywhere, but the hue jitter, which may differ by 1
(one level of a uint8 channel): Pillow's HSV conversions mix float and
double arithmetic, reproduced here operation by operation (seen: exact).
"""

import random

import numpy as np
import pytest
from PIL import Image

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.data import Cityscapes as JaxCityscapes
from codeps_tpu.data import DataLoader as JaxDataLoader
from codeps_tpu.data import Kitti360 as JaxKitti360
from codeps_tpu.data import SemKittiDvps as JaxSemKittiDvps
from codeps_tpu.data import dataset as jdataset
from codeps_tpu.data import preprocessing as jprep
from codeps_tpu.data import synthetic as jsynthetic

from codeps_torch.config import gen_config
from codeps_torch.data import dataset, preprocessing, synthetic
from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.kitti_360 import Kitti360
from codeps_torch.data.loader import DataLoader, collate_batch
from codeps_torch.data.sem_kitti_dvps import SemKittiDvps

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


JITTER = [(name, factor) for name in ("brightness", "contrast",
                                      "saturation")
          for factor in (0.0, 0.8, 0.97, 1.0, 1.13, 1.2, 1.6)]


@pytest.mark.parametrize("name,factor", JITTER)
def test_enhance_matches_pillow(name, factor):
    img = _image(0)
    ref = np.asarray(getattr(jprep, f"adjust_{name}")(Image.fromarray(img),
                                                      factor))
    ours = getattr(preprocessing, f"adjust_{name}")(img, factor)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("factor", [-0.5, -0.1, -0.03, 0.0, 0.04, 0.1, 0.5])
def test_hue_matches_pillow(factor):
    img = _image(1)
    ref = np.asarray(jprep.adjust_hue(Image.fromarray(img), factor))
    ours = preprocessing.adjust_hue(img, factor)
    assert np.abs(ours.astype(int) - ref).max() <= HUE_TOL


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


def _augmentation(flip):
    cfg = gen_config(adapt=True, freeze=False).dataset.augmentation
    cfg.horizontal_flipping = flip
    return cfg


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


# ------------------------------------------------------------- readers

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
