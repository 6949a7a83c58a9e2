"""Synthetic dataset trees for tests.

Counterpart of ``codeps_tpu/data/synthetic.py``: tiny on-disk trees in the
Cityscapes and KITTI-360 layouts, so the readers run end to end without
real data. The same seeds give the same files as the JAX
package's helpers. PIL and cv2 are imported inside the functions that
write files.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def _random_rgb(rng, width, height):
    from PIL import Image
    return Image.fromarray(
        rng.integers(0, 255, (height, width, 3), dtype=np.uint8), "RGB")


def _blocky_labels(rng, width, height, raw_classes, num_instances,
                   thing_raw_ids):
    """Random stuff bands + thing rectangles in raw label ids."""
    semantic = np.full((height, width),
                       raw_classes[rng.integers(len(raw_classes))], np.uint8)
    bands = np.linspace(0, height, 4).astype(int)
    for i in range(3):
        semantic[bands[i]:bands[i + 1]] = raw_classes[
            rng.integers(len(raw_classes))]
    instance = semantic.astype(np.int32) * 1000
    for i in range(num_instances):
        y = int(rng.integers(0, max(height - 8, 1)))
        x = int(rng.integers(0, max(width - 10, 1)))
        h = int(rng.integers(5, 10))
        w = int(rng.integers(6, 12))
        raw_id = thing_raw_ids[int(rng.integers(len(thing_raw_ids)))]
        semantic[y:y + h, x:x + w] = raw_id
        instance[y:y + h, x:x + w] = raw_id * 1000 + i + 1
    return semantic, instance


def make_cityscapes_tree(root: Path, num_frames: int = 3, width: int = 96,
                         height: int = 64, split: str = "train",
                         seed: int = 0, with_disparity: bool = True) -> Path:
    """Create a minimal Cityscapes tree (city 'synth', one sequence)."""
    import cv2
    rng = np.random.default_rng(seed)
    root = Path(root)
    city = "synth"
    gt_dir = root / "gtFine" / split / city
    rgb_dir = root / "leftImg8bit_sequence" / split / city
    cam_dir = root / "camera" / split / city
    disp_dir = root / "disparity_sequence" / split / city
    for directory in (gt_dir, rgb_dir, cam_dir, disp_dir):
        directory.mkdir(parents=True, exist_ok=True)

    seq = "000000"
    # Frame numbers with +-1 neighbors available.
    for center in range(1, num_frames + 1):
        base = f"{city}_{seq}_{center:06d}"
        for number in (center - 1, center, center + 1):
            rgb_path = rgb_dir / \
                f"{city}_{seq}_{number:06d}_leftImg8bit.png"
            if not rgb_path.exists():
                _random_rgb(rng, width, height).save(rgb_path)
            if with_disparity:
                disp_path = disp_dir / \
                    f"{city}_{seq}_{number:06d}_disparity.png"
                if not disp_path.exists():
                    disp = rng.integers(1000, 20000, (height, width))
                    cv2.imwrite(str(disp_path), disp.astype(np.uint16))

        semantic, instance = _blocky_labels(
            rng, width, height,
            raw_classes=[7, 8, 11, 21, 23], num_instances=3,
            thing_raw_ids=[24, 26])
        cv2.imwrite(str(gt_dir / f"{base}_gtFine_labelIds.png"), semantic)
        cv2.imwrite(str(gt_dir / f"{base}_gtFine_instanceIds.png"),
                    instance.astype(np.uint16))
        with open(cam_dir / f"{base}_camera.json", "w",
                  encoding="utf-8") as handle:
            json.dump({
                "intrinsic": {"fx": 60.0, "fy": 60.0,
                              "u0": width / 2, "v0": height / 2},
                "extrinsic": {"baseline": 0.2},
            }, handle)
    return root


def make_kitti360_tree(root: Path, sequence: str = "03",
                       num_frames: int = 6, width: int = 96,
                       height: int = 64, seed: int = 1,
                       with_semantics: bool = True,
                       semantic_gaps=()) -> Path:
    """Create a minimal KITTI-360 tree for 'sequence' streaming mode.

    ``semantic_gaps``: frame numbers WITHOUT semantic/instance
    annotations (KITTI-360 annotates sparsely; exercises the skip
    arithmetic of sequence_reference_mode="semantic").
    """
    import cv2
    rng = np.random.default_rng(seed)
    root = Path(root)
    drive = f"2013_05_28_drive_00{sequence}_sync"
    rgb_dir = root / "data_2d_raw" / drive / "image_00" / "data_rect"
    sem_dir = root / "data_2d_semantics" / "train" / drive / "image_00" / \
        "semantic"
    inst_dir = root / "data_2d_semantics" / "train" / drive / "image_00" / \
        "instance"
    velo_dir = root / "data_3d_raw" / drive / "velodyne_points" / "data"
    calib_dir = root / "calibration"
    for directory in (rgb_dir, sem_dir, inst_dir, velo_dir, calib_dir):
        directory.mkdir(parents=True, exist_ok=True)

    for number in range(num_frames + 2):
        _random_rgb(rng, width, height).save(rgb_dir / f"{number:010d}.png")
        # Velodyne scan: points in front of the (identity-calib) camera.
        pcl = np.zeros((256, 4), np.float32)
        pcl[:, 2] = rng.uniform(2.0, 60.0, 256)                  # depth
        pcl[:, 0] = rng.uniform(-0.6, 0.6, 256) * pcl[:, 2]      # x
        pcl[:, 1] = rng.uniform(-0.4, 0.4, 256) * pcl[:, 2]      # y
        pcl[:, 3] = 1.0
        pcl.tofile(velo_dir / f"{number:010d}.bin")
        if (with_semantics and 0 < number <= num_frames
                and number not in semantic_gaps):
            semantic, instance = _blocky_labels(
                rng, width, height,
                raw_classes=[7, 8, 11, 21, 23], num_instances=2,
                thing_raw_ids=[24, 26])
            cv2.imwrite(str(sem_dir / f"{number:010d}.png"), semantic)
            cv2.imwrite(str(inst_dir / f"{number:010d}.png"),
                        instance.astype(np.uint16))

    fx, fy = 60.0, 60.0
    cx, cy = width / 2, height / 2
    with open(calib_dir / "perspective.txt", "w", encoding="utf-8") as f:
        f.write(f"P_rect_00: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n")
        f.write("R_rect_00: 1 0 0 0 1 0 0 0 1\n")
    np.savetxt(calib_dir / "calib_cam_to_velo.txt",
               np.hstack([np.eye(3), np.zeros((3, 1))]).reshape(1, -1))
    return root
