"""``python -m codeps_torch.scripts.infer`` end to end on the CPU.

A ``.pth`` in the reference layout, written from the port's seeded
ResNet-18 modules with ``torch.save``, runs through the CLI on two tiny
PNGs; the raw ``.npz`` must equal what the facade returns for the same
frames, and the panels must exist at the feed size.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from codeps_torch.config import load_config
from codeps_torch.models import CodepsNet, build_modules, init_params

REPO = Path(__file__).resolve().parent.parent

TINY_YAML = """\
model:
  po_depth_net:
    params:
      nof_layers: 18
dataset:
  feed_img_size: [64, 128]
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_infer_cli_matches_facade(tmp_path):
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    cfg = load_config(str(cfg_path))
    modules = init_params(build_modules(cfg, 14, device="cpu"), seed=3,
                          device="cpu")
    with torch.no_grad():
        modules.instance_head.center_head.net.conv.bias.fill_(0.12)
    ckpt = tmp_path / "codeps.pth"
    state = {name: getattr(modules, name).state_dict()
             for name in modules.module_names()}
    torch.save({"state_dict": state}, ckpt)

    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    frames = []
    for name in ("000000", "000001"):
        arr = rng.integers(0, 255, (64, 128, 3), np.uint8)
        Image.fromarray(arr).save(img_dir / f"{name}.png")
        frames.append(arr)

    out_dir = tmp_path / "preds"
    proc = subprocess.run(
        [sys.executable, "-m", "codeps_torch.scripts.infer",
         "--checkpoint", str(ckpt), "--filename_config", str(cfg_path),
         "--images", str(img_dir), "--output", str(out_dir), "--save_raw",
         "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]

    norm = cfg.dataset.normalization
    net = CodepsNet(modules, thing_list=(9, 10, 11, 12, 13),
                    rgb_mean=norm.rgb_mean, rgb_std=norm.rgb_std,
                    device="cpu")
    for i, stem in enumerate(("000000", "000001")):
        # one frame per call, as the CLI's default batch of 1 runs them
        expected = net(frames[i][None], mode="eval")
        assert (expected["instance"] > 0).any()
        for panel in ("rgb", "depth", "semantic", "panoptic"):
            assert Image.open(out_dir / f"{stem}_{panel}.png").size \
                == (128, 64)
        raw = np.load(out_dir / f"{stem}.npz")
        np.testing.assert_array_equal(raw["depth"],
                                      expected["depth"][0, ..., 0].numpy())
        np.testing.assert_array_equal(raw["semantic"],
                                      expected["semantic"][0].numpy())
        np.testing.assert_array_equal(raw["panoptic"],
                                      expected["panoptic"][0].numpy())
