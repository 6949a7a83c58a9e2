"""The port's replay buffer and similarity index against ``codeps_tpu``'s,
on the same synthetic trees, seeds and call sequences.

The JAX buffer augments with the module ``random``, the port's with the
``random.Random`` it is given: both start from one seed. Tolerances: the
sampled indices, evictions, ids and label arrays exact; frames exact but
for the hue jitter's 1 level of a uint8 channel (see test_torch_data.py),
so float frames within 1/255 over the normalization's std (and exact in
the mean); feature vectors exact (the same numpy float32 arithmetic).
"""

import random

import numpy as np
import pytest

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.data import Cityscapes as JaxCityscapes
from codeps_tpu.data import Kitti360 as JaxKitti360
from codeps_tpu.data.replay_buffer import ReplayBuffer as JaxReplayBuffer
from codeps_tpu.native.simindex import SimIndex as JaxSimIndex

from codeps_torch.config import gen_config
from codeps_torch.data.cityscapes import Cityscapes
from codeps_torch.data.dataset import class_distribution
from codeps_torch.data.kitti_360 import Kitti360
from codeps_torch.data.replay_buffer import (PREV_TARGET_OFFSET,
                                             ReplayBuffer, rare_class_sample)
from codeps_torch.data.simindex import SimIndex
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)

SEED = 3
# one level of a uint8 channel, normalized by the smallest std
FRAME_TOL = 1.0 / 255.0 / 0.224 + 1e-6


@pytest.mark.parametrize("native", [False, True])
def test_simindex_matches(native):
    rng = np.random.default_rng(0)
    dim = 16
    ours, ref = SimIndex(dim), JaxSimIndex(dim, force_numpy=not native)
    for start in (0, 10, 20):
        vectors = rng.normal(size=(10, dim)).astype(np.float32)
        vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
        ids = np.arange(start, start + 10) * 3
        ours.add_with_ids(vectors, ids)
        ref.add_with_ids(vectors, ids)
    assert ours.ntotal == ref.ntotal == 30
    queries = rng.normal(size=(4, dim)).astype(np.float32)
    for k in (1, 5, 40):
        s_ours, i_ours = ours.search(queries, k)
        s_ref, i_ref = ref.search(queries, k)
        np.testing.assert_array_equal(i_ours, i_ref)
        np.testing.assert_allclose(s_ours, s_ref, rtol=1e-6, atol=1e-6)
    removed = np.asarray([3, 30, 999, 87])
    assert ours.remove_ids(removed) == ref.remove_ids(removed) == 3
    for a, b in zip(ours.dump(), ref.dump()):
        np.testing.assert_array_equal(a, b)
    empty = SimIndex(dim)
    scores, ids = empty.search(queries[:1], 2)
    assert (ids == -1).all() and np.isinf(scores).all()


def _configure(cfg, roots, diversity=True, target_size=3):
    cfg.dataset.name = "kitti_360"
    cfg.dataset.path = str(roots["k360"])
    cfg.dataset.feed_img_size = [32, 48]
    cfg.dataset.center_heatmap_sigma = 4
    cfg.adapt.source_dataset.name = "cityscapes"
    cfg.adapt.source_dataset.path = str(roots["cs"])
    cfg.adapt.source_dataset.feed_img_size = [32, 64]
    for key in ("center_heatmap_sigma", "augmentation", "normalization"):
        cfg.adapt.source_dataset[key] = cfg.dataset[key]
    cfg.adapt.replay_sampler.nof_source_samples = 2
    cfg.adapt.replay_sampler.nof_target_samples = 2
    cfg.adapt.replay_buffer.maximize_diversity = diversity
    cfg.adapt.replay_buffer.target_size = target_size
    cfg.adapt.replay_buffer.similarity_threshold = 0.9
    cfg.adapt.mixup.general.nof_samples = 2
    cfg.adapt.mixup.general.mixup_strategies = ["cut_mixup", "class_mixup"]
    cfg.dataset.augmentation.horizontal_flipping = True
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_replay")
    return {"cs": make_cityscapes_tree(tmp / "cs", num_frames=5),
            "k360": make_kitti360_tree(tmp / "k360", num_frames=10)}


def _buffers(roots, number_samples=None, **kwargs):
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False), roots,
                      **kwargs)
    pcfg = _configure(gen_config(adapt=True, freeze=False), roots, **kwargs)
    ref = JaxReplayBuffer(JaxKitti360("sequence", jcfg.dataset,
                                      return_depth=True, sequences=["03"]),
                          jcfg.adapt, "train")
    ref.initialize_source_buffer(
        JaxCityscapes("train", jcfg.adapt.source_dataset), number_samples)
    ours = ReplayBuffer(Kitti360("sequence", pcfg.dataset, return_depth=True,
                                 sequences=["03"]),
                        pcfg.adapt, "train", rng=random.Random(SEED))
    ours.initialize_source_buffer(
        Cityscapes("train", pcfg.adapt.source_dataset), number_samples)
    random.seed(SEED)
    return ref, ours


def _assert_items_equal(ours, ref, where):
    assert set(ours) == set(ref), where
    for key, value in ref.items():
        if key == "rgb" or key in ("rgb_src", "rgb_tgt"):
            assert set(ours[key]) == set(value), (where, key)
            for o, img in value.items():
                img = np.asarray(img)
                err = np.abs(ours[key][o].astype(np.float64) - img)
                tol = FRAME_TOL if img.dtype != np.uint8 else 1
                assert err.max() <= tol, (where, key, o, err.max())
        elif isinstance(value, (np.ndarray, np.generic)):
            np.testing.assert_array_equal(ours[key], value,
                                          err_msg=f"{where} {key}")
        else:
            assert ours[key] == value, (where, key)


def _assert_samples_equal(ours, ref):
    """``ours`` leaves out the reference's augmented target copies
    ("target_augmented"), which nothing reads."""
    ref = {k: v for k, v in ref.items() if k != "target_augmented"}
    assert set(ours) == set(ref)
    assert ours["index"] == ref["index"]
    assert ours["target_is_low_contrast"] == ref["target_is_low_contrast"]
    _assert_items_equal(ours["target"], ref["target"], "target")
    for key in ("source", "target_replay", "cut_mixup", "class_mixup"):
        if key in ref:
            assert len(ours[key]) == len(ref[key]), key
            for i, (a, b) in enumerate(zip(ours[key], ref[key])):
                _assert_items_equal(a, b, f"{key}[{i}]")


def test_buffer_items_adds_and_evictions_match(roots):
    """The stream's order of calls: frame i is sampled, then frame i-2 is
    added, with features that make some adds evict."""
    ref, ours = _buffers(roots)
    assert len(ours) == len(ref) == 7
    np.testing.assert_array_equal(ours.buffer_indices["source"],
                                  ref.buffer_indices["source"])
    features = np.random.default_rng(5).normal(size=(len(ref), 1, 64))
    features[4] = features[1] * 2.0          # similar to a kept frame
    replayed = 0
    for i in range(len(ref)):
        sample = ref[i]
        _assert_samples_equal(ours[i], sample)
        replayed += "target_replay" in sample
        if i >= 2:
            ref.add(i - 2, features[i - 2].astype(np.float32))
            ours.add(i - 2, features[i - 2].astype(np.float32))
            np.testing.assert_array_equal(ours.buffer_indices["target"],
                                          ref.buffer_indices["target"])
            np.testing.assert_array_equal(ours.buffer_indices["source"],
                                          ref.buffer_indices["source"])
    for a, b in zip(ours.sim_index.dump(), ref.sim_index.dump()):
        np.testing.assert_array_equal(a, b)
    assert replayed == len(ref) - 3              # from frame 3 on
    assert ours.sim_index.ntotal == 3            # full, with evictions
    np.testing.assert_array_equal(ours.distance_matrix_indices,
                                  ref.distance_matrix_indices)
    np.testing.assert_array_equal(ours.distance_matrix, ref.distance_matrix)
    # the samplers are in step after it all
    assert ours.mixup_sampler.random() == ref.mixup_sampler.random()
    assert ours.target_sampler.random() == ref.target_sampler.random()
    assert ours.rng.random() == random.random()


def test_sampled_item_has_replay_and_mixup(roots):
    _, ours = _buffers(roots)
    ours.add(0, np.ones((1, 8), np.float32))
    item = ours[1]
    assert len(item["source"]) == 2
    assert len(item["target_replay"]) == 2
    assert "target_augmented" not in item
    strategies = [k for k in ("cut_mixup", "class_mixup") if k in item]
    assert strategies == ["cut_mixup", "class_mixup"]
    mix = item["class_mixup"][0]
    assert mix["rgb_src"][0].shape == (32, 64, 3)
    assert mix["rgb_tgt"][0].shape == (32, 48, 3)
    assert mix["tgt_is_replay"] == 1
    assert "rgb_original" not in item["target"]


def test_random_eviction_without_diversity(roots):
    ref, ours = _buffers(roots, diversity=False, target_size=2)
    for i in range(6):
        ref.add(i)
        ours.add(i)
        np.testing.assert_array_equal(ours.buffer_indices["target"],
                                      ref.buffer_indices["target"])
    assert ours.buffer_indices["target"].sum() == 2


def test_rare_class_source_buffer_matches(roots, tmp_path):
    """The published source initialization (maximize_diversity with a
    source size): the port's counted class distribution, pickled where the
    JAX reader looks, draws the same images on both sides."""
    import pickle
    pcfg = _configure(gen_config(adapt=True, freeze=False), roots)
    source = Cityscapes("train", pcfg.adapt.source_dataset)
    dist = class_distribution(source)
    path = roots["cs"] / "class_distribution.pkl"
    with open(path, "wb") as handle:
        pickle.dump(dist, handle)
    try:
        ref, ours = _buffers(roots, number_samples=3)
        assert ours.source_samples_indices == ref.source_samples_indices
        assert len(ours.source_samples_indices) == 3
        np.testing.assert_array_equal(ours.buffer_indices["source"],
                                      ref.buffer_indices["source"])
        assert sorted(rare_class_sample(dist, 3, 20)) == sorted(
            rare_class_sample(dist, 3, 20))
        with pytest.raises(ValueError):
            rare_class_sample(dist, len(source) + 1, 20)
    finally:
        path.unlink()


def test_save_and_load_state(roots, tmp_path):
    _, ours = _buffers(roots)
    features = np.random.default_rng(9).normal(size=(4, 1, 32)).astype(
        np.float32)
    for i in range(4):
        ours.add(i, features[i])
    path = str(tmp_path / "state.pkl")
    ours.save_state(path)
    ids, vectors = ours.sim_index.dump()

    _, nxt = _buffers(roots)
    nxt.load_state(path=path)
    assert nxt.buffer_indices["prev_target"] == [
        PREV_TARGET_OFFSET + int(i) for i in ids]
    new_ids, new_vectors = nxt.sim_index.dump()
    np.testing.assert_array_equal(new_ids, ids + PREV_TARGET_OFFSET)
    np.testing.assert_array_equal(new_vectors, vectors)
    # a full buffer comes back with its similarity matrix and a free slot
    assert nxt.distance_matrix.shape == (len(ids) + 1, len(ids) + 1)
    assert nxt.distance_matrix_indices[-1] == -1
    # the previous domain's frames are sampled through its own dataset
    item = nxt._get_target_item(int(new_ids[0]), do_augmentation=False,
                                do_network_preparation=False)
    assert set(item) == {"rgb", "camera_model"}
