"""Cityscapes reader.

Counterpart of ``codeps_tpu/data/cityscapes.py``: frames keyed by the
gtFine labelIds files, RGB triplets from ``leftImg8bit_sequence``, the
per-frame camera JSON, instance ids semantic * 1000 + id with crowd
regions (raw id < 1000) removed, small-instance weights, center/offset
ground truth and depth from disparity. Frames are numpy ``uint8`` arrays;
PIL and cv2 are imported only where files are read.

``_read`` does the file reading and ``__getitem__`` everything after it,
so an in-memory source of the same frames can override ``_read`` alone.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from benchmark.reference.codeps_ref.data.dataset import Dataset

# labelIds -> trainIds; codeps merges wall into building and motorcycle
# and bicycle into two-wheeler
_MAPPING_CITYSCAPES = [
    (7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6), (20, 7),
    (21, 8), (22, 9), (23, 10), (24, 11), (25, 12), (26, 13), (27, 14),
    (28, 15), (31, 16), (32, 17), (33, 18),
]
_MAPPING_CODEPS = [
    (7, 0), (8, 1), (11, 2), (12, 2), (13, 3), (17, 4), (20, 5), (21, 6),
    (22, 7), (23, 8), (24, 9), (25, 10), (26, 11), (27, 12), (32, 13),
    (33, 13),
]


class Cityscapes(Dataset):

    def __init__(self, mode: str, cfg, return_depth: bool = False,
                 return_only_rgb: bool = False, label_mode: str = "codeps"):
        super().__init__("cityscapes", ["train", "val"], mode, cfg,
                         return_depth, return_only_rgb, label_mode)
        self.frame_paths = self._get_frames()
        if self.return_only_rgb:
            self.frame_paths = self._get_frames_only_rgb()

    # ------------------------------------------------------------------

    def _get_frames(self) -> List[Dict[str, Path]]:
        semantic_files = sorted(
            (self.path_base / "gtFine" / self.mode).glob(
                "*/*_gtFine_labelIds.png"))
        frames = []
        for semantic in semantic_files:
            file_base = semantic.stem.replace("_gtFine_labelIds", "")
            city = file_base.split("_")[0]
            rgb = (self.path_base / "leftImg8bit_sequence" / self.mode /
                   city / f"{file_base}_leftImg8bit.png")
            instance = semantic.parent / semantic.name.replace("label",
                                                               "instance")
            camera = (self.path_base / "camera" / self.mode / city /
                      f"{file_base}_camera.json")
            disparity = (self.path_base / "disparity_sequence" / self.mode /
                         city / f"{file_base}_disparity.png"
                         if self.return_depth else None)
            frame = {"rgb": rgb, "semantic": semantic, "instance": instance,
                     "camera": camera, "disparity": disparity}
            for path in frame.values():
                if path is not None:
                    assert path.exists(), f"File does not exist: {path}"
            frames.append(frame)
        return frames

    def _get_frames_only_rgb(self) -> List[Dict[str, Path]]:
        """Every frame of the sequences around the labelled ones."""
        frames = []
        max_offset = max(self.offsets)
        for frame in self.frame_paths:
            image = frame["rgb"]
            center_number = image.stem.split("_")[2]
            digits = len(center_number)
            sequence_files = []
            for direction in (-1, 1):
                i = direction
                while True:
                    number = int(center_number) + i
                    path = image.parent / image.name.replace(
                        center_number, str(number).zfill(digits))
                    if path.exists():
                        sequence_files.append(path)
                        i += direction
                    else:
                        break
            sequence_files.sort()
            sequence_files = sequence_files[max_offset:-max_offset]
            for file in sequence_files:
                disparity = None
                if self.return_depth:
                    disparity = Path(
                        str(file).replace("leftImg8bit", "disparity"))
                    assert disparity.exists(), f"Missing: {disparity}"
                frames.append({"rgb": file, "camera": frame["camera"],
                               "disparity": disparity})
        return frames

    # ------------------------------------------------------------------

    def _read(self, index: int, with_labels: bool) -> Dict[str, Any]:
        """The files of frame ``index``: ``rgb`` {offset: uint8 (H, W, 3)}
        at the feed size, ``image_size`` (W, H) of the full-size image, the
        ``camera`` JSON and, with labels, the raw ``semantic`` and
        ``instance`` maps resized (nearest) to the feed size; ``depth``
        when asked for."""
        import cv2
        from PIL import Image
        frame = self.frame_paths[index]
        image_path = frame["rgb"]
        with Image.open(image_path) as img:
            image_size = img.size  # (W, H)
        out: Dict[str, Any] = {"rgb": {0: self.resize(image_path)},
                               "image_size": image_size}
        center_number = image_path.stem.split("_")[2]
        digits = len(center_number)
        for offset in self.offsets:
            number = int(center_number) + offset
            path = image_path.parent / image_path.name.replace(
                center_number, str(number).zfill(digits))
            assert path.exists(), f"Offset file does not exist: {path}"
            out["rgb"][offset] = self.resize(path)
        with open(frame["camera"], "r", encoding="utf-8") as handle:
            out["camera"] = json.load(handle)

        height, width = self.image_size
        if with_labels:
            semantic = cv2.imread(str(frame["semantic"]),
                                  cv2.IMREAD_GRAYSCALE)
            out["semantic"] = cv2.resize(semantic, (width, height),
                                         interpolation=cv2.INTER_NEAREST)
            instance = cv2.imread(str(frame["instance"]),
                                  cv2.IMREAD_ANYDEPTH)
            out["instance"] = cv2.resize(instance, (width, height),
                                         interpolation=cv2.INTER_NEAREST)
        if self.return_depth:
            disparity = cv2.imread(str(frame["disparity"]),
                                   cv2.IMREAD_UNCHANGED).astype(np.float32)
            disparity[disparity > 0] = (disparity[disparity > 0] - 1) / 256
            focal_length_x = out["camera"]["intrinsic"]["fx"]
            baseline = out["camera"]["extrinsic"]["baseline"]
            depth = np.zeros_like(disparity)
            depth[disparity > 0] = (baseline * focal_length_x) / \
                disparity[disparity > 0]
            out["depth"] = cv2.resize(depth, (width, height),
                                      interpolation=cv2.INTER_NEAREST)
        return out

    def __getitem__(self, index: int, do_network_preparation: bool = True,
                    do_augmentation: bool = True,
                    return_only_rgb: bool = False,
                    rng: random.Random | None = None) -> Dict[str, Any]:
        with_labels = not (self.return_only_rgb or return_only_rgb)
        raw = self._read(index, with_labels)
        intr = raw["camera"]["intrinsic"]
        height, width = self.image_size
        scale_u = width / raw["image_size"][0]
        scale_v = height / raw["image_size"][1]
        camera_model = np.asarray(
            [intr["fx"] * scale_u, intr["fy"] * scale_v,
             intr["u0"] * scale_u, intr["v0"] * scale_v], np.float32)
        output: Dict[str, Any] = {"rgb": raw["rgb"],
                                  "camera_model": camera_model}
        if with_labels:
            output.update(self._labels(raw["semantic"], raw["instance"],
                                       raw["image_size"]))
        if self.return_depth:
            output["depth"] = raw["depth"]
        return self._finish(output, do_augmentation, do_network_preparation,
                            rng)

    def _labels(self, semantic: np.ndarray, instance: np.ndarray,
                image_size) -> Dict[str, np.ndarray]:
        """Train ids, instance ids (class * 1000 + id, crowd removed),
        weights and the center/offset ground truth from the raw maps at
        the feed size."""
        height, width = self.image_size
        semantic_city = self._convert_semantics(semantic)
        class_instance = instance.astype(np.int64) - \
            semantic.astype(np.int64) * 1000
        thing_mask = self._make_thing_mask(semantic_city, as_bool=True)
        instance_msk = thing_mask.copy()
        instance_msk[instance < 1000] = False
        instance_city = np.zeros_like(instance, dtype=np.uint16)
        instance_city[instance_msk] = (
            semantic_city[instance_msk].astype(np.int64) * 1000
            + class_instance[instance_msk]).astype(np.uint16)

        semantic_weights = np.ones_like(instance_city, dtype=np.uint8)
        semantic_weights[semantic_city == 255] = 0

        full_res_w, full_res_h = image_size
        small_instance_area = (self.small_instance_area_full_res
                               * (height / full_res_h)
                               * (width / full_res_w))
        inst_id, inst_area = np.unique(instance_city, return_counts=True)
        for instance_id, instance_area in zip(inst_id, inst_area):
            if instance_id == 0:
                continue
            if instance_area < small_instance_area:
                semantic_weights[instance_city == instance_id] = \
                    self.small_instance_weight

        offset, center = self.get_offset_center(instance_city)
        center_weights = np.ones_like(center, dtype=np.uint8)
        center_weights[semantic_city == 255] = 0
        return {
            "semantic": semantic_city,
            "semantic_weights": semantic_weights,
            "center": center,
            "center_weights": center_weights,
            "offset": offset,
            "offset_weights": instance_msk.astype(np.uint8)[..., None],
            "thing_mask": thing_mask.astype(np.uint8),
            "instance": instance_city.astype(np.int32),
        }

    def _convert_semantics(self, semantic: np.ndarray) -> np.ndarray:
        mapping = (_MAPPING_CITYSCAPES if self.label_mode == "cityscapes"
                   else _MAPPING_CODEPS)
        return self._apply_mapping(semantic, mapping)
