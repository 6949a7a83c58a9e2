"""Dataset base class of the host-side numpy pipeline.

Counterpart of ``codeps_tpu/data/dataset.py``: offsets expansion, the
Gaussian center-heatmap kernel, per-instance center/offset ground truth,
thing masks, class-removal remapping and the class distribution behind
the replay buffer's rare-class source sampling. Samples hold numpy arrays
(frames are ``uint8`` (H, W, 3)), never PIL images; the readers import
PIL and cv2 only inside the functions that read files.

Arrays are channel-last: center (H, W, 1), offset (H, W, 2) as (dy, dx).
"""

from __future__ import annotations

import abc
import pickle
import random
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from benchmark.reference.codeps_ref.config import ConfigNode
from benchmark.reference.codeps_ref.data import labels as labels_lib


def make_center_gaussian(sigma: float) -> np.ndarray:
    """(6 sigma + 3)^2 Gaussian kernel."""
    size = 6 * sigma + 3
    x = np.arange(0, size, 1, float)
    y = x[:, np.newaxis]
    x0 = y0 = 3 * sigma + 1
    return np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))


def get_offset_center(instance_map: np.ndarray, sigma: float = 8,
                      gaussian: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Center heatmap and per-pixel offsets to the instance centers:
    offset (H, W, 2) as (dy, dx), center (H, W, 1)."""
    if gaussian is None:
        gaussian = make_center_gaussian(sigma)

    height, width = instance_map.shape
    center = np.zeros((height, width, 1), np.float32)
    offset = np.zeros((height, width, 2), np.float32)
    y_coord, x_coord = np.mgrid[0:height, 0:width].astype(np.float32)

    for instance_id in np.unique(instance_map):
        if instance_id == 0:
            continue
        mask_index = np.where(instance_map == instance_id)
        center_y = np.mean(mask_index[0])
        center_x = np.mean(mask_index[1])

        y, x = int(np.round(center_y)), int(np.round(center_x))
        if not (0 <= x < width and 0 <= y < height):
            continue
        ul = int(np.round(x - 3 * sigma - 1)), int(np.round(y - 3 * sigma - 1))
        br = int(np.round(x + 3 * sigma + 2)), int(np.round(y + 3 * sigma + 2))

        c, d = max(0, -ul[0]), min(br[0], width) - ul[0]
        a, b = max(0, -ul[1]), min(br[1], height) - ul[1]
        cc, dd = max(0, ul[0]), min(br[0], width)
        aa, bb = max(0, ul[1]), min(br[1], height)
        center[aa:bb, cc:dd, 0] = np.maximum(center[aa:bb, cc:dd, 0],
                                             gaussian[a:b, c:d])

        offset[mask_index[0], mask_index[1], 0] = \
            center_y - y_coord[mask_index]
        offset[mask_index[0], mask_index[1], 1] = \
            center_x - x_coord[mask_index]

    return offset, center


def class_distribution(dataset) -> Dict[str, dict]:
    """Per-class pixel counts over a dataset's un-augmented samples, the
    dict the replay buffer's rare-class sampling reads
    (``scripts/compute_class_distribution.py``): ``num_pixels`` {class:
    pixels}, ``class_images`` {class: [indices]}, ``images_num_pixels``
    {index: {class: pixels}}; void (255) is not counted."""
    num_pixels: Dict[int, int] = defaultdict(int)
    class_images: Dict[int, List[int]] = defaultdict(list)
    images_num_pixels: Dict[int, Dict[int, int]] = defaultdict(dict)
    for index in range(len(dataset)):
        sample = dataset.__getitem__(index, do_network_preparation=False,
                                     do_augmentation=False)
        classes, counts = np.unique(np.asarray(sample["semantic"]),
                                    return_counts=True)
        for cls, count in zip(classes, counts):
            cls = int(cls)
            if cls == 255:
                continue
            num_pixels[cls] += int(count)
            class_images[cls].append(index)
            images_num_pixels[index][cls] = int(count)
    return {"num_pixels": dict(num_pixels),
            "class_images": dict(class_images),
            "images_num_pixels": dict(images_num_pixels)}


class Dataset(abc.ABC):
    """Base of the Cityscapes and KITTI-360 readers. ``__getitem__``'s
    ``rng`` draws the augmentation; without one it comes from the module
    ``random``, as in the JAX package."""

    def __init__(self, assert_name: str, assert_modes: List[str], mode: str,
                 cfg, return_depth: bool = False,
                 return_only_rgb: bool = False, label_mode: str = "codeps"):
        assert mode in assert_modes, f"Unsupported mode: {mode}"
        self.mode = mode
        self.return_depth = return_depth
        self.return_only_rgb = return_only_rgb
        assert label_mode in ("codeps", "cityscapes"), \
            f"Unsupported label mode: {label_mode}"
        self.label_mode = label_mode

        assert cfg.name == assert_name
        self.path_base = Path(cfg.path)
        self.image_size = list(cfg.feed_img_size)  # [H, W]
        offsets = list(cfg.offsets)
        self.offsets = [-x for x in reversed(offsets)] + offsets
        self.sigma = cfg.center_heatmap_sigma
        self.small_instance_weight = cfg.small_instance_weight
        self.small_instance_area_full_res = cfg.small_instance_area_full_res
        self.augmentation_cfg = cfg.augmentation
        self.normalization_cfg = cfg.normalization
        self.remove_classes = list(cfg.remove_classes)
        if self.mode == "val":
            self.augmentation_cfg = ConfigNode({"active": False})

        self.gaussian = make_center_gaussian(self.sigma)
        self.frame_paths: List[Dict[str, Any]] = []
        dist_file = self.path_base / "class_distribution.pkl"
        self.class_distribution_file = (dist_file if dist_file.exists()
                                        else None)

    # ------------------------------------------------------------------

    def resize(self, path) -> np.ndarray:
        """The RGB image at ``path``, LANCZOS-resized to the feed size, as
        uint8 (H, W, 3)."""
        from PIL import Image
        img = Image.open(path).convert("RGB")
        return np.asarray(img.resize((self.image_size[1], self.image_size[0]),
                                     Image.LANCZOS))

    def load_class_distribution(self):
        """The pickled ``class_distribution`` next to the data, or None."""
        if self.class_distribution_file is None:
            return None
        with open(self.class_distribution_file, "rb") as handle:
            return pickle.load(handle)

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.frame_paths)

    @abc.abstractmethod
    def __getitem__(self, index: int, do_network_preparation: bool = True,
                    do_augmentation: bool = True,
                    return_only_rgb: bool = False,
                    rng: random.Random | None = None) -> Dict[str, Any]:
        ...

    def _finish(self, output, do_augmentation, do_network_preparation,
                rng) -> Dict[str, Any]:
        from benchmark.reference.codeps_ref.data.preprocessing import (augment_data,
                                                     prepare_for_network)
        if do_augmentation:
            augment_data(output, self.augmentation_cfg,
                         rng if rng is not None else random)
        if do_network_preparation:
            prepare_for_network(output, self.normalization_cfg)
        return output

    # ------------------------------------------------------------------

    def _make_thing_mask(self, semantic: np.ndarray,
                         as_bool: bool = False) -> np.ndarray:
        mask = np.zeros_like(semantic, dtype=np.uint8)
        for thing in self.thing_classes:
            mask[semantic == thing] = 1
        return mask.astype(bool) if as_bool else mask

    def get_offset_center(self, instance_map: np.ndarray):
        return get_offset_center(instance_map, self.sigma, self.gaussian)

    @staticmethod
    def _rm_classes_mapping(remove_classes: List[int],
                            mapping_list: List[Tuple[int, int]]
                            ) -> List[Tuple[int, int]]:
        """Renumber a (raw_id, train_id) map after class removal."""
        sub_list = dict.fromkeys(mapping_list, 0)
        for k_del in remove_classes:
            for elem in mapping_list:
                if elem not in sub_list:
                    continue
                if elem[1] > k_del:
                    sub_list[elem] += 1
                elif elem[1] == k_del:
                    del sub_list[elem]
        return [(k[0], k[1] - v) for k, v in sub_list.items()]

    def _apply_mapping(self, semantic: np.ndarray,
                       mapping_list: List[Tuple[int, int]]) -> np.ndarray:
        mapping_list = self._rm_classes_mapping(self.remove_classes,
                                                mapping_list)
        out = np.full_like(semantic, 255, dtype=np.uint8)
        for raw_id, train_id in mapping_list:
            out[semantic == raw_id] = train_id
        return out

    # ------------------------------------------------------------------

    @property
    def stuff_classes(self) -> List[int]:
        return labels_lib.stuff_classes(self.label_mode, self.remove_classes)

    @property
    def thing_classes(self) -> List[int]:
        return labels_lib.thing_classes(self.label_mode, self.remove_classes)

    @property
    def all_classes(self) -> List[int]:
        return self.stuff_classes + self.thing_classes

    @property
    def ignore_classes(self) -> List[int]:
        """Classes present in Cityscapes but absent in this dataset."""
        return []

    @property
    def num_stuff(self) -> int:
        return len(self.stuff_classes)

    @property
    def num_things(self) -> int:
        return len(self.thing_classes)

    @property
    def num_classes(self) -> int:
        return len(self.all_classes)
