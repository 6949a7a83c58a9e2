"""KITTI-360 reader.

Counterpart of ``codeps_tpu/data/kitti_360.py``: train/val splits from the
official frame lists, 'sequence' mode streaming the rectified
``data_2d_raw`` images (with the fixed subset of sequence 09), intrinsics
from the perspective calibration scaled to the feed size, GT depth from
the Velodyne scans, and KITTI-360's label merges. Frames are numpy
``uint8`` arrays; PIL and cv2 are imported only where files are read.

``_read`` does the file reading and ``__getitem__`` everything after it,
so an in-memory source of the same frames can override ``_read`` alone.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from codeps_torch.data.dataset import Dataset

_MAPPING_CITYSCAPES = [
    (7, 0), (8, 1), (11, 2), (12, 3), (13, 4), (17, 5), (19, 6), (20, 7),
    (21, 8), (22, 9), (23, 10), (24, 11), (25, 12), (26, 13), (27, 14),
    (28, 15), (31, 16), (32, 17), (33, 18),
    (34, 2),   # garage -> building
    (35, 4),   # gate -> fence
    (37, 5),   # smallpole -> pole
]
_MAPPING_CODEPS = [
    (7, 0), (8, 1), (11, 2), (34, 2), (12, 2), (13, 3), (35, 3), (17, 4),
    (37, 4), (20, 5), (21, 6), (22, 7), (23, 8), (24, 9), (25, 10),
    (26, 11), (27, 12), (32, 13), (33, 13),
]

_VALID_SEQUENCES = ("00", "02", "03", "04", "05", "06", "07", "09", "10")


class Kitti360(Dataset):

    def __init__(self, mode: str, cfg, return_depth: bool = False,
                 return_only_rgb: bool = False,
                 sequences: Optional[List[str]] = None,
                 sequence_reference_mode: str = "rgb",
                 label_mode: str = "codeps"):
        super().__init__("kitti_360", ["train", "val", "sequence"], mode,
                         cfg, return_depth, return_only_rgb, label_mode)
        if mode == "sequence":
            assert sequence_reference_mode in ("semantic", "rgb")
            assert sequences, "In 'sequence' mode, sequences must be given."
            for seq in sequences:
                assert seq in _VALID_SEQUENCES, f"Invalid sequence: {seq}"
        self.sequence_reference_mode = sequence_reference_mode
        # which frames the 'semantic' reference mode skipped (the replay
        # buffer's split index accounts for them)
        self.semantic_seq_mode_image_skipped: List[bool] = []

        self.sequences = sequences if self.mode == "sequence" else None
        self.frame_paths = self._get_frames()
        if self.return_only_rgb:
            assert self.mode != "sequence", "Not implemented"
            self.frame_paths = self._get_frames_only_rgb()
        self.camera_model = self._read_calibration()
        self.lidar_to_rect, self.camera_matrix = None, None
        if self.return_depth:
            self.lidar_to_rect, self.camera_matrix = self._read_lidar_to_rect()

    # ------------------------------------------------------------------

    def _get_frames(self) -> List[Dict[str, Any]]:
        frames = []
        if self.sequences is None:
            filename = (self.path_base / "data_2d_semantics" / "train" /
                        f"2013_05_28_drive_{self.mode}_frames.txt")
            with open(filename, "r", encoding="utf-8") as handle:
                lines = handle.read().splitlines()
            for line in lines:
                # no preceding file for this triplet
                if self.mode == "val" and "0000004391.png" in line:
                    continue
                rgb = self.path_base / line.split(" ")[0]
                semantic = self.path_base / line.split(" ")[1]
                instance = semantic.parents[1] / "instance" / semantic.name
                depth = (self.path_base / "data_3d_raw" /
                         semantic.parents[2].name / "velodyne_points" /
                         "data" / f"{semantic.stem}.bin"
                         if self.return_depth else None)
                frame = {"rgb": rgb, "semantic": semantic,
                         "instance": instance, "depth": depth}
                for path in frame.values():
                    if path is not None:
                        assert path.exists(), f"File does not exist: {path}"
                frames.append(frame)
        else:
            rgb_files: List[Path] = []
            for sequence in self.sequences:
                seq_files = sorted(
                    (self.path_base / "data_2d_raw" /
                     f"2013_05_28_drive_00{sequence}_sync" / "image_00" /
                     "data_rect").glob("*.png"))
                seq_files = seq_files[max(self.offsets):-max(self.offsets)]
                if sequence == "09":
                    seq_files = seq_files[4999:8499]
                rgb_files += seq_files
            for rgb in rgb_files:
                sequence = rgb.parents[2].name
                semantic = (self.path_base / "data_2d_semantics" / "train" /
                            sequence / "image_00" / "semantic" / rgb.name)
                instance = (self.path_base / "data_2d_semantics" / "train" /
                            sequence / "image_00" / "instance" / rgb.name)
                if self.sequence_reference_mode == "semantic":
                    if not semantic.exists() or not instance.exists():
                        self.semantic_seq_mode_image_skipped.append(True)
                        continue
                    self.semantic_seq_mode_image_skipped.append(False)
                else:
                    semantic = semantic if semantic.exists() else None
                    instance = instance if instance.exists() else None
                depth = (self.path_base / "data_3d_raw" / sequence /
                         "velodyne_points" / "data" / f"{rgb.stem}.bin"
                         if self.return_depth else None)
                frames.append({"rgb": rgb, "semantic": semantic,
                               "instance": instance, "depth": depth})
        return frames

    def _get_frames_only_rgb(self) -> List[Dict[str, Any]]:
        frames = []
        max_offset = max(self.offsets)
        for sequence in sorted((self.path_base / "data_2d_raw").glob("*")):
            seq_files = sorted(sequence.glob("image_00/data_rect/*.png"))
            seq_files = seq_files[max_offset:-max_offset]
            frames += [{"rgb": file} for file in seq_files]
        return frames

    # ------------------------------------------------------------------

    def _read_calibration(self) -> np.ndarray:
        """(4,) intrinsics scaled to the feed size."""
        from PIL import Image
        filename = self.path_base / "calibration" / "perspective.txt"
        with open(filename, "r", encoding="utf-8") as handle:
            lines = handle.read().splitlines()
        parameters = np.zeros((3, 4))
        for line in lines:
            if line.split(" ")[0] == "P_rect_00:":
                parameters = np.fromstring(
                    line.replace("P_rect_00: ", ""), dtype=float,
                    sep=" ").reshape(3, 4)
                break
        with Image.open(self.frame_paths[0]["rgb"]) as img:
            image_size = img.size
        height, width = self.image_size
        scale_u = width / image_size[0]
        scale_v = height / image_size[1]
        return np.asarray([parameters[0, 0] * scale_u,
                           parameters[1, 1] * scale_v,
                           parameters[0, 2] * scale_u,
                           parameters[1, 2] * scale_v], np.float32)

    def _read_lidar_to_rect(self):
        cam_to_velo_path = self.path_base / "calibration" / \
            "calib_cam_to_velo.txt"
        lastrow = np.array([0, 0, 0, 1]).reshape(1, 4)
        cam_to_velo = np.concatenate(
            (np.loadtxt(cam_to_velo_path).reshape(3, 4), lastrow))
        rect_path = self.path_base / "calibration" / "perspective.txt"
        with open(rect_path, "r", encoding="utf-8") as handle:
            lines = handle.read().splitlines()
        rect, cam_matrix = np.eye(4), np.eye(3, 4)
        for line in lines:
            if line.split(" ")[0] == "R_rect_00:":
                rect[:3, :3] = np.fromstring(
                    line.replace("R_rect_00: ", ""), dtype=float,
                    sep=" ").reshape(3, 3)
            elif line.split(" ")[0] == "P_rect_00:":
                cam_matrix = np.fromstring(
                    line.replace("P_rect_00: ", ""), dtype=float,
                    sep=" ").reshape(3, 4)
        velo_to_rect = rect @ np.linalg.inv(cam_to_velo)
        return velo_to_rect, cam_matrix

    def _project_velodyne(self, depth_path, image_size) -> np.ndarray:
        """Sparse depth map at the feed size from a Velodyne scan."""
        import cv2
        pcl = np.fromfile(depth_path, dtype=np.float32).reshape(-1, 4)
        pcl[:, 3] = 1
        points_cam = (self.lidar_to_rect @ pcl.T).T[:, :3].T[None]
        points_proj = self.camera_matrix[:3, :3].reshape(1, 3, 3) @ points_cam
        depth = points_proj[:, 2, :]
        depth[depth == 0] = -1e-6
        u = np.round(points_proj[:, 0, :] / np.abs(depth)).astype(np.int64)
        v = np.round(points_proj[:, 1, :] / np.abs(depth)).astype(np.int64)
        image_width, image_height = image_size
        depth_map = np.zeros((image_height, image_width))
        mask = (u >= 0) & (u < image_width) & (v >= 0) & (v < image_height)
        mask &= (depth > 0) & (depth < 80)
        depth_map[v[mask], u[mask]] = depth[mask]
        return cv2.resize(depth_map,
                          (self.image_size[1], self.image_size[0]),
                          interpolation=cv2.INTER_NEAREST)

    # ------------------------------------------------------------------

    def _read(self, index: int, with_labels: bool) -> Dict[str, Any]:
        """The files of frame ``index``: ``rgb`` {offset: uint8 (H, W, 3)}
        at the feed size, ``image_size`` (W, H) of the full-size image and,
        with labels, the raw ``semantic`` and ``instance`` id maps resized
        (nearest) to the feed size, and ``depth`` when asked for."""
        import cv2
        from PIL import Image
        image_path = self.frame_paths[index]["rgb"]
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
        if not with_labels:
            return out
        frame = self.frame_paths[index]
        if frame.get("semantic") is not None \
                and frame.get("instance") is not None:
            height, width = self.image_size
            semantic = cv2.imread(str(frame["semantic"]),
                                  cv2.IMREAD_GRAYSCALE)
            out["semantic"] = cv2.resize(semantic, (width, height),
                                         interpolation=cv2.INTER_NEAREST)
            instance = cv2.imread(str(frame["instance"]),
                                  cv2.IMREAD_ANYDEPTH)
            out["instance"] = cv2.resize(instance, (width, height),
                                         interpolation=cv2.INTER_NEAREST)
        if self.return_depth:
            out["depth"] = self._project_velodyne(frame["depth"], image_size)
        return out

    def __getitem__(self, index: int, do_network_preparation: bool = True,
                    do_augmentation: bool = True,
                    return_only_rgb: bool = False,
                    rng: random.Random | None = None) -> Dict[str, Any]:
        with_labels = not (self.return_only_rgb or return_only_rgb)
        raw = self._read(index, with_labels)
        output: Dict[str, Any] = {"rgb": raw["rgb"],
                                  "camera_model": self.camera_model.copy()}
        if with_labels:
            if raw.get("semantic") is not None:
                output.update(self._labels(raw["semantic"], raw["instance"],
                                           raw["image_size"]))
            if self.return_depth:
                output["depth"] = raw["depth"]
        return self._finish(output, do_augmentation, do_network_preparation,
                            rng)

    def _labels(self, semantic: np.ndarray, instance: np.ndarray,
                image_size) -> Dict[str, np.ndarray]:
        """Train ids, instance ids (class * 1000 + id), weights and the
        center/offset ground truth from the raw maps at the feed size."""
        height, width = self.image_size
        semantic_city = self._convert_semantics(semantic)
        class_instance = instance.astype(np.int64) - \
            semantic.astype(np.int64) * 1000
        thing_mask = self._make_thing_mask(semantic_city, as_bool=True)
        instance_city = np.zeros_like(instance, dtype=np.uint16)
        instance_city[thing_mask] = (
            semantic_city[thing_mask].astype(np.int64) * 1000
            + class_instance[thing_mask]).astype(np.uint16)

        semantic_weights = np.ones_like(instance_city, dtype=np.uint8)
        semantic_weights[semantic_city == 255] = 0
        semantic_eval = semantic_city.copy()

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
            # the evaluation variant drops very small instances
            if instance_area < small_instance_area * 0.1:
                semantic_eval[instance_city == instance_id] = 255

        offset, center = self.get_offset_center(instance_city)
        return {
            "semantic": semantic_city,
            "semantic_eval": semantic_eval,
            "semantic_weights": semantic_weights,
            "center": center,
            "center_weights": self._make_thing_mask(semantic_city)[..., None],
            "offset": offset,
            "offset_weights": self._make_thing_mask(semantic_city)[..., None],
            "thing_mask": thing_mask.astype(np.uint8),
            "instance": instance_city.astype(np.int32),
        }

    def _convert_semantics(self, semantic: np.ndarray) -> np.ndarray:
        mapping = (_MAPPING_CITYSCAPES if self.label_mode == "cityscapes"
                   else _MAPPING_CODEPS)
        return self._apply_mapping(semantic, mapping)
