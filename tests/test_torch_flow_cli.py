"""The port's two CLIs with ``model.make_sflow: true`` on the CPU, port
only (no JAX compile; tests/test_torch_flow.py holds the steps against
the JAX package).

- ``python -m codeps_torch.scripts.adapt`` with ``adapt.model.sflow:
  true`` streams 2 frames of the synthetic KITTI-360 tree (before any
  target replay) from a ``.pth`` that holds the flow head and the
  8-channel pose net, then validates: the flow losses are in the
  stream's meters, finite, and the checkpoint's flow head and pose net
  reach the modules bit for bit.
- ``python -m codeps_torch.scripts.train`` takes one step on the
  synthetic Cityscapes tree and validates with losses, the flow terms
  among them.
"""

import math

import numpy as np
import pytest
import torch

from codeps_torch.config import gen_config
from codeps_torch.data.synthetic import (make_cityscapes_tree,
                                         make_kitti360_tree)
from codeps_torch.io.checkpoint import (pretrained_from_checkpoints,
                                        save_checkpoint)
from codeps_torch.models import build_modules, init_params
from codeps_torch.scripts import adapt as adapt_cli
from codeps_torch.scripts import train as train_cli

NC = 14

ADAPT_YAML = """
model:
  make_sflow: true
  po_depth_net:
    params:
      nof_layers: 18
adapt:
  model:
    backbone_po_depth: false
    instance: false
    sflow: true
  ema:
    semantic: true
    alpha: 0.99
  source_dataset:
    name: cityscapes
    path: {cs_root}
    feed_img_size: [32, 64]
  replay_sampler:
    nof_source_samples: 2
    nof_target_samples: 2
  mixup:
    general:
      mixup_strategies: [cut_mixup, cut_mixup]
      nof_samples: 2
dataset:
  name: kitti_360
  path: {root}
  sequences: ["03"]
  feed_img_size: [32, 64]
  center_heatmap_sigma: 4
  small_instance_area_full_res: 100
tpu:
  compute_dtype: float32
semantics:
  class_weights: [{weights}]
"""

TRAIN_YAML = """
model:
  make_depth: true
  make_sflow: true
  make_semantic: true
  make_instance: true
  instance_head:
    use_thing_mask: true
  po_depth_net:
    params:
      nof_layers: 18
train:
  nof_epochs: 1
  batch_size_per_gpu: 2
  nof_workers_per_gpu: 0
val:
  batch_size_per_gpu: 2
dataset:
  name: cityscapes
  path: {root}
  feed_img_size: [64, 96]
  center_heatmap_sigma: 4
  augmentation:
    active: false
semantics:
  class_weights: [{weights}]
  top_k: 0.2
logging:
  val_epoch_interval: 1
tpu:
  compute_dtype: float32
"""


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _not_finite(metrics):
    return {k: float(v) for k, v in metrics.items()
            if np.ndim(v) == 0 and not math.isfinite(float(v))}


def test_adapt_cli_streams_with_the_flow_head(tmp_path):
    cs_root = make_cityscapes_tree(tmp_path / "cs", num_frames=4, width=96,
                                   height=64)
    make_cityscapes_tree(cs_root, num_frames=2, width=96, height=64,
                         split="val", seed=5)
    root = make_kitti360_tree(tmp_path / "k360", num_frames=6, width=96,
                              height=64)
    config = tmp_path / "flow.yaml"
    config.write_text(ADAPT_YAML.format(cs_root=cs_root, root=root,
                                        weights=", ".join(["1.0"] * NC)))
    cfg = gen_config(str(config), adapt=True)
    saved = init_params(build_modules(cfg, NC, device="cpu"), seed=3,
                        device="cpu")
    assert tuple(saved.backbone_pose_sflow.encoder.conv1.weight.shape) \
        == (64, 8, 7, 7)
    checkpoint = tmp_path / "flow.pth"
    save_checkpoint(str(checkpoint), cfg, saved)

    loaded = build_modules(cfg, NC, device="cpu")
    assert "flow_head" in pretrained_from_checkpoints([str(checkpoint)],
                                                      loaded, cfg)
    for name in ("flow_head", "backbone_pose_sflow"):
        ours = getattr(loaded, name).state_dict()
        for key, value in getattr(saved, name).state_dict().items():
            assert torch.equal(ours[key], value), (name, key)

    result = adapt_cli.main([
        "--run_name", "flow", "--filename_config", str(config),
        "--checkpoint", str(checkpoint), "--max_frames", "2",
        "--experiments_dir", str(tmp_path / "exp"), "--device", "cpu"])
    losses = result["meters"]["losses"]
    for name in ("flow_smth", "flow_sparsity", "depth_recon"):
        assert losses[name].count == 2, name
        assert math.isfinite(float(losses[name].value)), name
    assert float(losses["flow_sparsity"].value) > 0
    for split in ("target_val", "source_val"):
        assert result[split] is not None and not _not_finite(result[split])


def test_train_cli_steps_and_validates_with_flow_losses(tmp_path):
    root = make_cityscapes_tree(tmp_path / "cs", num_frames=2, width=96,
                                height=64)
    make_cityscapes_tree(root, num_frames=2, width=96, height=64,
                         split="val", seed=5)
    config = tmp_path / "flow.yaml"
    config.write_text(TRAIN_YAML.format(root=root,
                                        weights=", ".join(["1.0"] * NC)))
    result = train_cli.main([
        "--run_name", "flow", "--filename_config", str(config),
        "--max_steps", "1", "--experiments_dir", str(tmp_path / "exp"),
        "--device", "cpu"])
    assert result["global_step"] == 1
    step = result["metrics"][0]
    assert {"flow_smth", "flow_sparsity", "semantic", "center"} <= set(step)
    assert not _not_finite(step)
    val = result["val"][0]
    assert {"val_loss_flow_smth", "val_loss_flow_sparsity",
            "val_loss_depth_recon", "p_pq"} <= set(val)
    assert not _not_finite(val)
    assert result["state"].modules.flow_head is not None
