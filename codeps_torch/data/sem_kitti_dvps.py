"""SemanticKITTI-DVPS reader.

Counterpart of ``codeps_tpu/data/sem_kitti_dvps.py``: the ViP-DeepLab
splits (train 00-10 without 08, val 08), frames keyed by the 16-bit depth
PNGs (value / 256 is metric depth), intrinsics from ``calib.txt``'s P2
scaled to the feed size, and the KITTI -> codeps/cityscapes label maps
(bicyclist and motorcyclist -> rider, parking -> road, trunk ->
vegetation). Frames are numpy ``uint8`` arrays; PIL and cv2 are imported
only where files are read.

``_read`` does the file reading and ``__getitem__`` everything after it,
so an in-memory source of the same frames can override ``_read`` alone.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

import numpy as np

from codeps_torch.data.dataset import Dataset, get_offset_center

_MAPPING_CITYSCAPES = [
    (8, 0), (10, 1), (12, 2), (13, 4), (17, 5), (18, 7), (14, 8), (16, 9),
    (5, 11), (6, 12), (7, 12), (0, 13), (3, 14), (2, 17), (1, 18),
    (9, 0),    # parking -> road
    (15, 8),   # trunk -> vegetation
]
_MAPPING_CODEPS = [
    (8, 0), (9, 0), (10, 1), (12, 2), (13, 3), (17, 4), (18, 5), (14, 6),
    (15, 6), (16, 7), (5, 9), (6, 10), (7, 10), (0, 11), (3, 12), (2, 13),
    (1, 13),
]

_TRAIN_SEQUENCES = ["00", "02", "03", "04", "05", "06", "07", "09", "10"]
_VALID_SEQUENCES = _TRAIN_SEQUENCES + ["08"]


class SemKittiDvps(Dataset):

    def __init__(self, mode: str, cfg, return_depth: bool = False,
                 return_only_rgb: bool = False,
                 sequences: Optional[List[str]] = None,
                 label_mode: str = "codeps"):
        super().__init__("sem_kitti_dvps", ["train", "val", "sequence"],
                         mode, cfg, return_depth, return_only_rgb,
                         label_mode)
        if mode == "sequence":
            assert sequences, "In 'sequence' mode, sequences must be given."
            for seq in sequences:
                assert seq in _VALID_SEQUENCES, f"Invalid sequence: {seq}"

        if self.mode == "train":
            self.sequences = list(_TRAIN_SEQUENCES)
        elif self.mode == "val":
            self.sequences = ["08"]
        else:
            self.sequences = sequences
        self.frame_paths = self._get_frames()

    def _get_frames(self) -> List[Dict[str, Any]]:
        depth_files = []
        for sequence in self.sequences:
            seq_files = sorted(
                (self.path_base / "data_2d_depth" / sequence).glob("*.png"))
            seq_files = seq_files[max(self.offsets):-max(self.offsets)]
            depth_files += seq_files

        frames = []
        for depth in depth_files:
            sequence = depth.parent.name
            frame_id = depth.name.split("_")[0]
            rgb = (self.path_base / "data_2d_raw" / sequence / "image_2" /
                   f"{frame_id}.png")
            camera = self.path_base / "data_2d_raw" / sequence / "calib.txt"
            semantic = (self.path_base / "data_2d_semantics" / sequence /
                        f"{frame_id}_class.png")
            instance = (self.path_base / "data_2d_semantics" / sequence /
                        f"{frame_id}_instance.png")
            frame = {"rgb": rgb, "semantic": semantic, "instance": instance,
                     "camera": camera,
                     "depth": depth if self.return_depth else None}
            for path in frame.values():
                if path is not None:
                    assert path.exists(), f"File does not exist: {path}"
            frames.append(frame)
        return frames

    # ------------------------------------------------------------------

    def _read(self, index: int, with_labels: bool) -> Dict[str, Any]:
        """The files of frame ``index``: ``rgb`` {offset: uint8 (H, W, 3)}
        at the feed size, ``image_size`` (W, H) of the full-size image,
        ``p2`` the 12 values of the calibration's P2 and, with labels, the
        raw ``semantic`` and ``instance`` maps resized (nearest) to the
        feed size, and the metric ``depth`` when asked for."""
        import cv2
        from PIL import Image
        frame = self.frame_paths[index]
        image_path = frame["rgb"]
        with Image.open(image_path) as img:
            image_size = img.size
        out: Dict[str, Any] = {"rgb": {0: self.resize(image_path)},
                               "image_size": image_size}
        center_number = image_path.stem
        digits = len(center_number)
        for offset in self.offsets:
            number = int(center_number) + offset
            path = image_path.parent / f"{str(number).zfill(digits)}.png"
            assert path.exists(), f"Offset file does not exist: {path}"
            out["rgb"][offset] = self.resize(path)
        with open(frame["camera"], "r", encoding="utf-8") as handle:
            line = handle.readlines()[2].replace("P2: ", "")
        out["p2"] = [float(value) for value in line.split(" ")]
        if not with_labels:
            return out
        height, width = self.image_size
        for key in ("semantic", "instance"):
            raw = cv2.imread(str(frame[key]), cv2.IMREAD_ANYDEPTH)
            out[key] = cv2.resize(raw, (width, height),
                                  interpolation=cv2.INTER_NEAREST)
        if self.return_depth:
            depth = cv2.imread(str(frame["depth"]),
                               cv2.IMREAD_ANYDEPTH).astype(np.float32)
            depth[depth > 0] /= 256
            out["depth"] = cv2.resize(depth, (width, height),
                                      interpolation=cv2.INTER_NEAREST)
        return out

    def __getitem__(self, index: int, do_network_preparation: bool = True,
                    do_augmentation: bool = True,
                    return_only_rgb: bool = False,
                    rng: random.Random | None = None) -> Dict[str, Any]:
        with_labels = not (self.return_only_rgb or return_only_rgb)
        raw = self._read(index, with_labels)
        p2 = raw["p2"]
        height, width = self.image_size
        scale_u = width / raw["image_size"][0]
        scale_v = height / raw["image_size"][1]
        camera_model = np.asarray([p2[0] * scale_u, p2[5] * scale_v,
                                   p2[2] * scale_u, p2[6] * scale_v],
                                  np.float32)
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
        """Train ids, instance ids (void removed), weights and the
        center/offset ground truth from the raw maps at the feed size."""
        height, width = self.image_size
        semantic_city = self._convert_semantics(semantic)
        instance_city = instance.copy()
        instance_city[semantic_city == 255] = 0

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

        # The reference's quirk, kept: this reader's center heatmaps use
        # the default sigma of 8 whatever center_heatmap_sigma says
        # (sem_kitti_dvps.py:168); the other readers pass the configured
        # one.
        offset, center = get_offset_center(instance_city)
        center_weights = np.ones_like(center, dtype=np.uint8)
        center_weights[semantic_city == 255] = 0
        offset_weights = self._make_thing_mask(semantic_city)[..., None]
        return {
            "semantic": semantic_city,
            "semantic_weights": semantic_weights,
            "center": center,
            "center_weights": center_weights,
            "offset": offset,
            "offset_weights": offset_weights,
            # the reference's thing mask is the offset weights
            # (sem_kitti_dvps.py:185), here without the channel axis
            "thing_mask": offset_weights[..., 0],
            "instance": instance_city.astype(np.int32),
        }

    def _convert_semantics(self, semantic: np.ndarray) -> np.ndarray:
        mapping = (_MAPPING_CITYSCAPES if self.label_mode == "cityscapes"
                   else _MAPPING_CODEPS)
        return self._apply_mapping(semantic, mapping)

    @property
    def ignore_classes(self) -> List[int]:
        """Cityscapes classes absent in KITTI (sem_kitti_dvps.py:270-278)."""
        if self.label_mode == "cityscapes":
            return [3, 6, 10, 15, 16]
        if self.label_mode == "codeps":
            return []
        raise ValueError(f"Unsupported label mode: {self.label_mode}")
