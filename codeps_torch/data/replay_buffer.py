"""Replay buffer: the online-adaptation dataset.

Counterpart of ``codeps_tpu/data/replay_buffer.py:41-536``:
  - the target stream split at ``target_dataset_adapt_ratio``;
  - per item: the target (with its low-contrast flag), N source samples
    (histogram-matched to the target, then augmented), N target-replay
    samples and the mixup raw materials (the reference's unread augmented
    target copies are left out; their random draws are made);
  - exhaust-before-repeat source sampling;
  - rare-class source-buffer initialization (softmax((1 - freq) / 0.01),
    images weighted by the class's pixel count);
  - the diversity add and evict: normalized features in an inner-product
    index, inserted when the largest cosine similarity is under the
    threshold; on overflow the entry with the largest summed similarity
    goes, from an incrementally kept similarity matrix;
  - ``save_state``/``load_state`` for chains of domains (the previous
    domain's ids offset by 10000).

The samplers are the JAX package's ``np.random.default_rng`` streams, all
seeded from ``replay_sampler.seed`` (the eviction sampler and the source
buffer from ``replay_buffer.seed``). The augmentation draws come from
``rng``, a ``random.Random`` (seeded from ``replay_sampler.seed`` unless
given), where the JAX package uses the module ``random``. A lock guards
the buffer's state: a prefetch thread may sample while the runner adds.
"""

from __future__ import annotations

import copy
import functools
import pickle
import random
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from codeps_torch.data.preprocessing import (ImageWork, augment_data,
                                             is_low_contrast,
                                             prepare_for_network,
                                             transfer_histogram_style)
from codeps_torch.data.simindex import SimIndex

PREV_TARGET_OFFSET = 10000


class ReplayBuffer:

    def __init__(self, adaptation_data, cfg, mode: str,
                 rng: random.Random | None = None):
        assert mode in ("train", "val"), f"Unsupported mode: {mode}"
        self.target_data = adaptation_data
        self.source_data = None
        self.mode = mode

        skipped = sum(getattr(self.target_data,
                              "semantic_seq_mode_image_skipped", []))
        index = int((len(self.target_data) + skipped)
                    * cfg.target_dataset_adapt_ratio)
        if self.mode == "train":
            self.target_data.frame_paths = \
                self.target_data.frame_paths[:index]
        else:
            if getattr(self.target_data, "sequence_reference_mode",
                       "rgb") != "rgb":
                index -= sum(self.target_data
                             .semantic_seq_mode_image_skipped[:index])
            self.target_data.frame_paths = \
                self.target_data.frame_paths[index:]

        self.source_num_samples = cfg.replay_sampler.nof_source_samples
        self.target_num_samples = cfg.replay_sampler.nof_target_samples
        self.samplers_seed = cfg.replay_sampler.seed
        self.buffer_seed = cfg.replay_buffer.seed
        self.rng = rng if rng is not None else random.Random(
            self.samplers_seed)

        self.buffer_indices: Dict[str, Any] = {
            "target": np.zeros(len(self.target_data), np.int32)}
        self.source_samples_indices: List[int] = []
        self.lock = threading.Lock()

        if cfg.replay_buffer.target_size is not None:
            self.target_buffer_size = cfg.replay_buffer.target_size
        else:
            self.target_buffer_size = len(self.target_data)
        self.maximize_diversity = cfg.replay_buffer.maximize_diversity
        self.similarity_threshold = cfg.replay_buffer.similarity_threshold
        self.sim_index: Optional[SimIndex] = None
        self.distance_matrix = None
        self.distance_matrix_indices = None
        self.buffer_remove_sampler = np.random.default_rng(self.buffer_seed)

        self.source_sampler = np.random.default_rng(self.samplers_seed)
        self.target_sampler = np.random.default_rng(self.samplers_seed)
        self.mixup_sampler = np.random.default_rng(self.samplers_seed)

        self.cfg_mixup = cfg.mixup.clone()
        if cfg.mode == "off":
            self.cfg_mixup.defrost()
            self.cfg_mixup.general.active = False
            self.cfg_mixup.general.mixup_strategies = []
            self.cfg_mixup.freeze()

        self.prev_target_data = None
        self.verbose = False

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.target_data)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        output: Dict[str, Any] = {"index": index}
        rng = self.rng
        # the random draws happen in the reference's order as the item is
        # assembled; the frames' pixel work runs at the end, in parallel
        work = ImageWork()

        vanilla = self.target_data.__getitem__(
            index, do_augmentation=False, do_network_preparation=False)
        if self.mode == "train":
            for key in ("semantic_weights", "center_weights",
                        "offset_weights"):
                vanilla.pop(key, None)
            adaptation_item = {
                "rgb": dict(vanilla["rgb"]),
                "camera_model": copy.deepcopy(vanilla["camera_model"]),
            }
        tmp_center_img = vanilla["rgb"][0]
        low_contrast = is_low_contrast(
            vanilla["rgb"][0], fraction_threshold=0.2,
            lower_percentile=10, upper_percentile=90)
        prepare_for_network(vanilla, self.target_data.normalization_cfg,
                            work)
        output["target"] = vanilla
        output["target_is_low_contrast"] = low_contrast
        output["target"]["rgb_original"] = tmp_center_img

        if self.mode != "train":
            work.run()
            output["target"].pop("rgb_original", None)
            return output["target"]

        # ---------------- source replay (exhaust-before-repeat)
        if self.source_num_samples > 0:
            with self.lock:
                indices = self._sample_source_indices()
            output["source"] = []
            match = functools.partial(transfer_histogram_style,
                                      reference_img=adaptation_item["rgb"][0],
                                      mode="rgb")
            for i in indices:
                item = self.source_data.__getitem__(
                    int(i), do_augmentation=False,
                    do_network_preparation=False)
                original = item["rgb"][0]
                # histogram-match first, then augment
                for offset in item["rgb"]:
                    work.add(item["rgb"], offset, match)
                augment_data(item, self.source_data.augmentation_cfg, rng,
                             work)
                prepare_for_network(item,
                                    self.source_data.normalization_cfg, work)
                # after the augmentation, which would flip it
                item["rgb_original"] = original
                output["source"].append(item)

        # ---------------- augmented online target: its draws only
        self._draw_only(rng)

        # ---------------- target replay: the indices are chosen under the
        # lock, so an add that evicts cannot tear the view
        with self.lock:
            extra = len(self.buffer_indices.get("prev_target", []))
            have_targets = (self.target_num_samples > 0
                            and int(self.buffer_indices["target"].sum())
                            + extra > 0)
            if have_targets:
                buffer_indices = np.where(
                    self.buffer_indices["target"])[0].tolist()
                if extra > 0:
                    buffer_indices += self.buffer_indices["prev_target"]
                indices = self.target_sampler.choice(
                    buffer_indices, self.target_num_samples,
                    replace=self.target_num_samples > len(buffer_indices))
        if have_targets:
            output["target_replay"] = []
            for i in indices:
                item = self._get_target_item(
                    int(i), do_augmentation=False,
                    do_network_preparation=False)
                original = item["rgb"][0]
                augment_data(item, self.target_data.augmentation_cfg, rng,
                             work)
                prepare_for_network(item, self.target_data.normalization_cfg,
                                    work)
                item["rgb_original"] = original
                output["target_replay"].append(item)
                # the draws of its augmented copy
                self._draw_only(rng)

        # ---------------- mixup raw materials
        if self.source_num_samples == 0 and self.cfg_mixup.general.active:
            raise RuntimeError(
                "Mixup is active but source_num_samples equals 0")
        mixup_items = []
        if self.cfg_mixup.general.active:
            assert (self.cfg_mixup.general.nof_samples
                    == len(self.cfg_mixup.general.mixup_strategies)), \
                "nof_samples must match the number of mixup strategies"
            strategies = list(self.cfg_mixup.general.mixup_strategies)
            indices_tgt: List[int] = []
            indices_src: List[int] = []
            for mix_counter in range(1,
                                     self.cfg_mixup.general.nof_samples + 1):
                if not indices_src:
                    indices_src = list(range(self.source_num_samples))
                if not indices_tgt:
                    indices_tgt = list(range(self.target_num_samples))

                strategy = self.mixup_sampler.choice(strategies)
                strategies.remove(strategy)

                idx_src = int(self.mixup_sampler.choice(indices_src))
                sample_src = output["source"][idx_src]
                indices_src.remove(idx_src)

                if mix_counter == 1 or "target_replay" not in output:
                    sample_tgt = output["target"]
                    tgt_is_replay = 0
                else:
                    idx_tgt = int(self.mixup_sampler.choice(indices_tgt))
                    sample_tgt = output["target_replay"][idx_tgt]
                    indices_tgt.remove(idx_tgt)
                    tgt_is_replay = 1

                mixup_item = self._get_data_for_mixup(sample_src, sample_tgt,
                                                      rng, work)
                mixup_item["tgt_is_replay"] = tgt_is_replay
                output.setdefault(str(strategy), []).append(mixup_item)
                mixup_items.append((mixup_item, sample_tgt))

        work.run()
        for mixup_item, sample_tgt in mixup_items:
            mixup_item["rgb_tgt"] = {0: sample_tgt["rgb"][0]}
        for key in ("target", "target_replay", "source"):
            if key in output:
                items = output[key] if isinstance(output[key], list) \
                    else [output[key]]
                for item in items:
                    item.pop("rgb_original", None)
        return output

    # ------------------------------------------------------------------

    def _get_target_item(self, index: int, **kwargs):
        if index >= PREV_TARGET_OFFSET:
            return self.prev_target_data.__getitem__(
                index - PREV_TARGET_OFFSET, return_only_rgb=True, **kwargs)
        return self.target_data.__getitem__(index, return_only_rgb=True,
                                            **kwargs)

    def _draw_only(self, rng) -> None:
        """The random draws of an augmentation of the target, without its
        frames: the reference also builds augmented copies of the target
        and of each replayed frame ("target_augmented"), which nothing
        reads; making their draws keeps the augmentations that are read
        the same."""
        augment_data({"rgb": {}}, self.target_data.augmentation_cfg, rng)

    def _sample_source_indices(self) -> np.ndarray:
        """Exhaust-before-repeat sampling of the source buffer."""
        source = self.buffer_indices["source"]
        remaining = int(source.sum())
        if self.source_num_samples < remaining:
            candidates = np.where(source)[0].tolist()
            indices = self.source_sampler.choice(
                candidates, self.source_num_samples, replace=False)
            for i in indices:
                source[i] = 0
        elif self.source_num_samples == remaining:
            indices = np.where(source)[0]
            for i in self.source_samples_indices:
                source[i] = 1
        else:
            indices_1 = np.where(source)[0]
            for i in self.source_samples_indices:
                source[i] = 1
            candidates = np.where(source)[0].tolist()
            indices_2 = self.source_sampler.choice(
                candidates, self.source_num_samples - len(indices_1),
                replace=False)
            for i in indices_2:
                source[i] = 0
            indices = np.concatenate([indices_1, indices_2])
        return indices

    def _get_data_for_mixup(self, sample_src, sample_tgt, rng, work):
        """The raw materials of one mixup sample; ``rgb_tgt`` is filled in
        once ``work`` has run."""
        out: Dict[str, Any] = {}
        rgb_src = {"rgb": {0: sample_src["rgb_original"]}}
        work.add(rgb_src["rgb"], 0, functools.partial(
            transfer_histogram_style,
            reference_img=sample_tgt["rgb_original"], mode="rgb"))
        augment_data(rgb_src, self.source_data.augmentation_cfg, rng, work)
        prepare_for_network(rgb_src, self.source_data.normalization_cfg,
                            work)
        out["rgb_src"] = rgb_src["rgb"]
        out["semantic_src"] = np.asarray(sample_src["semantic"])
        out["instance_src"] = np.asarray(sample_src["instance"])
        out["camera_model_src"] = sample_src["camera_model"]
        out["camera_model_tgt"] = sample_tgt["camera_model"]
        return out

    # ------------------------------------------------------------------

    def initialize_source_buffer(self, source_data,
                                 number_samples: Optional[int]) -> None:
        """Fill the source buffer: all of ``source_data`` when
        ``number_samples`` is None, else that many images, by rare-class
        sampling under ``maximize_diversity``, at random otherwise."""
        if self.mode != "train":
            return
        if number_samples is not None:
            assert number_samples >= self.source_num_samples
        assert source_data.stuff_classes == self.stuff_classes
        assert source_data.thing_classes == self.thing_classes
        self.source_data = source_data
        self.buffer_indices["source"] = np.zeros(len(source_data), np.int32)

        if number_samples is not None:
            if self.maximize_diversity:
                data = source_data.load_class_distribution()
                if data is None:
                    raise FileNotFoundError(
                        "Rare-class source sampling needs the class "
                        "distribution (class_distribution.pkl next to the "
                        "data; python -m codeps_torch.scripts."
                        "compute_class_distribution writes it) for "
                        f"{source_data.path_base}.")
                self.source_samples_indices = rare_class_sample(
                    data, number_samples, self.buffer_seed)
            else:
                rng = np.random.default_rng(self.buffer_seed)
                self.source_samples_indices = rng.choice(
                    len(source_data), number_samples,
                    replace=False).tolist()
            self.source_samples_indices.sort()
        else:
            self.source_samples_indices = list(range(len(source_data)))
        for i in self.source_samples_indices:
            self.buffer_indices["source"][i] = 1

    # ------------------------------------------------------------------

    def add(self, index: int,
            image_features: Optional[np.ndarray] = None) -> None:
        """Add a seen frame and keep the buffer diverse.

        ``image_features`` are the frame's last-stage encoder features,
        (H', W', C) or (1, H', W', C), or already pooled (1, C); they are
        mean-pooled and L2-normalized here."""
        with self.lock:
            self._add_locked(index, image_features)

    def _add_locked(self, index: int,
                    image_features: Optional[np.ndarray] = None) -> None:
        if not self.maximize_diversity:
            self.buffer_indices["target"][index] = 1
            if self.buffer_indices["target"].sum() > self.target_buffer_size:
                candidates = np.where(
                    self.buffer_indices["target"])[0].tolist()
                remove_index = self.buffer_remove_sampler.choice(candidates)
                self.buffer_indices["target"][remove_index] = 0
            return

        assert image_features is not None
        feats = np.asarray(image_features, np.float32)
        if feats.ndim == 4:
            feats = feats[0]
        if feats.ndim == 3:
            feats = feats.mean(axis=(0, 1))
        elif feats.ndim == 2:
            feats = feats[0]
        flattened = feats[None]
        norm = np.linalg.norm(flattened, axis=1, keepdims=True)
        flattened = flattened / np.maximum(norm, 1e-12)

        if self.sim_index is None:
            self.sim_index = SimIndex(flattened.shape[1])

        extra = len(self.buffer_indices.get("prev_target", []))

        if self.sim_index.ntotal == 0:
            similarity = 0.0
        else:
            scores, _ = self.sim_index.search(flattened, 1)
            similarity = float(scores[0, 0])
        if similarity >= self.similarity_threshold:
            return

        self.sim_index.add_with_ids(flattened, np.asarray([index]))
        self.buffer_indices["target"][index] = 1
        if self.verbose:
            print(f"Added sample {index} to the target buffer | "
                  f"similarity {similarity}")

        if int(self.buffer_indices["target"].sum()) + extra \
                <= self.target_buffer_size:
            return

        # ---- evict the argmax of the summed pairwise similarity
        if self.distance_matrix is None:
            ids, vectors = self.sim_index.dump()
            self.distance_matrix = vectors @ vectors.T
            self.distance_matrix_indices = ids.astype(np.int64)
        else:
            fill = np.argwhere(self.distance_matrix_indices < 0)[0, 0]
            self.distance_matrix_indices[fill] = index
            ids, vectors = self.sim_index.dump()
            sims = (vectors @ flattened[0]).astype(np.float32)
            # the similarities in the order of distance_matrix_indices
            sorter = np.argsort(ids)
            sorter_idx = sorter[np.searchsorted(
                ids, self.distance_matrix_indices, sorter=sorter)]
            row = sims[sorter_idx]
            self.distance_matrix[fill, :] = row
            self.distance_matrix[:, fill] = row

        remove_tmp = int(np.argmax(self.distance_matrix.sum(0)
                                   - self.distance_matrix.diagonal()))
        self.distance_matrix[:, remove_tmp] = -1
        self.distance_matrix[remove_tmp, :] = -1
        remove_index = int(self.distance_matrix_indices[remove_tmp])
        self.distance_matrix_indices[remove_tmp] = -1
        self.sim_index.remove_ids(np.asarray([remove_index]))

        if remove_index >= PREV_TARGET_OFFSET:
            self.buffer_indices["prev_target"].remove(remove_index)
        else:
            self.buffer_indices["target"][remove_index] = 0
        if self.verbose:
            print(f"Removed sample {remove_index} from the target buffer")

    # ------------------------------------------------------------------

    def save_state(self, path: str = "buffer_state.pkl") -> None:
        """Persist the buffer's features, frame paths and target dataset
        for the next domain of a chain."""
        ids, vectors = self.sim_index.dump()
        with open(path, "wb") as handle:
            pickle.dump({
                "target_samples_indices": ids.tolist(),
                "features": [vectors[i] for i in range(len(ids))],
                "target_frame_paths": self.target_data.frame_paths,
                "target_dataset": self.target_data,
            }, handle)

    def load_state(self, prev_target_data=None,
                   path: str = "buffer_state.pkl") -> None:
        """Restore a previous domain's buffer as ``prev_target`` entries;
        its dataset comes from the file unless one is passed, which is
        then pointed at the saved frame paths."""
        with open(path, "rb") as handle:
            state = pickle.load(handle)
        if prev_target_data is None:
            prev_target_data = state.get("target_dataset")
            if prev_target_data is None:
                raise ValueError(f"{path} holds no dataset; pass "
                                 "prev_target_data explicitly")
            self.prev_target_data = prev_target_data
        else:
            self.prev_target_data = prev_target_data
            self.prev_target_data.frame_paths = state["target_frame_paths"]
        indices = state["target_samples_indices"]
        features = state["features"]

        self.buffer_indices["prev_target"] = [
            PREV_TARGET_OFFSET + idx for idx in indices]
        self.sim_index = SimIndex(features[0].size)
        for idx, feature in zip(indices, features):
            self.sim_index.add_with_ids(
                np.asarray(feature, np.float32).reshape(1, -1),
                np.asarray([PREV_TARGET_OFFSET + idx]))

        if self.sim_index.ntotal == self.target_buffer_size:
            ids, vectors = self.sim_index.dump()
            n = len(ids) + 1
            self.distance_matrix_indices = np.append(
                ids.astype(np.int64), [-1])
            self.distance_matrix = -np.ones((n, n), np.float32)
            self.distance_matrix[:n - 1, :n - 1] = vectors @ vectors.T

    # ------------------------------------------------------------------

    @property
    def stuff_classes(self):
        return self.target_data.stuff_classes

    @property
    def thing_classes(self):
        return self.target_data.thing_classes

    @property
    def ignore_classes(self):
        return self.target_data.ignore_classes

    @property
    def num_classes(self):
        return self.target_data.num_classes

    @property
    def num_things(self):
        return self.target_data.num_things

    @property
    def num_stuff(self):
        return self.target_data.num_stuff


def rare_class_sample(distribution: Dict[str, dict], number_samples: int,
                      seed: int) -> List[int]:
    """Image indices drawn class first: a class with probability
    softmax((1 - pixel share) / 0.01), then one of its images weighted by
    the class's pixels in it, until ``number_samples`` distinct images are
    drawn (unsorted, in draw order)."""
    number_pixels = distribution["num_pixels"]
    class_images = distribution["class_images"]
    images_numbers_pixels = distribution["images_num_pixels"]
    if number_samples > len(images_numbers_pixels):
        raise ValueError(f"{number_samples} source samples asked for, the "
                         f"distribution covers {len(images_numbers_pixels)} "
                         "images")

    total = sum(number_pixels.values())
    frequency = {c: n / total for c, n in number_pixels.items()}
    temperature = 0.01
    probability = {c: np.exp((1 - f) / temperature)
                   for c, f in frequency.items()}
    norm = sum(probability.values())
    probability = {c: p / norm for c, p in probability.items()}

    sampler = np.random.default_rng(seed)
    indices: List[int] = []
    while len(indices) < number_samples:
        sampled_class = sampler.choice(list(probability.keys()),
                                       p=list(probability.values()))
        possible = class_images[sampled_class]
        weights = np.asarray([images_numbers_pixels[img][sampled_class]
                              for img in possible], np.float64)
        sampled_image = sampler.choice(possible, p=weights / weights.sum())
        if sampled_image not in indices:
            indices.append(sampled_image)
    return indices
