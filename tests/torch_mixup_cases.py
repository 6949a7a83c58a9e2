"""Cameras shared by ``tests/test_torch_mixup*.py``."""

import numpy as np

# KITTI-360's camera 00 (1408x376) and a Cityscapes camera (2048x1024)
KITTI_360 = (552.554261, 552.554261, 682.049453, 238.769549)
CITYSCAPES = (2262.52, 2265.3017905988554, 1096.98, 513.137)
HT, WT = 32, 64
HS, WS = 32, 96

def _camera(intrinsics, full, size):
    """``intrinsics`` of an image of ``full`` (W, H) scaled to ``size``
    (H, W)."""
    sx, sy = size[1] / full[0], size[0] / full[1]
    fx, fy, cx, cy = intrinsics
    return np.asarray([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)
