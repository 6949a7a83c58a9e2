"""The port's pose network (6-channel ResNet-18 and pose head) against
Flax ``apply`` on the same weights, its encoder also in train mode, where
BatchNorm normalizes with the batch's statistics: Flax takes the
variance as E[x^2] - E[x]^2, torch in two passes, well inside the
tolerance at these sizes (``tests/test_torch_models.py`` gives the
weights and the tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codeps_tpu.config import get_cfg_defaults_adapt as jax_cfg_defaults
from codeps_tpu.io.convert_pth import convert_checkpoint
from codeps_tpu.models.heads import PoseHead as JaxPoseHead
from codeps_tpu.models.resnet import make_encoder

from codeps_torch.io import from_jax
from codeps_torch.models.heads import PoseHead
from codeps_torch.models.resnet import keep_running_stats
from codeps_torch.models.resnet import make_encoder as make_pose_encoder
from torch_model_cases import (HEIGHT, WIDTH, _assert_close, _flax_init,
                               _nhwc, _torch_feats)
from torch_model_cases import few_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pose_net():
    """The 6-channel ResNet-18 pose encoder and the pose head in Flax,
    with perturbed weights, two frames stacked on the channel axis, and
    the encoder's pyramid in eval and in train mode."""
    encoder = make_encoder(18, num_input_images=2)
    enc_params, enc_stats = _flax_init(
        encoder, jnp.zeros((1, HEIGHT, WIDTH, 6)), train=False)
    pairs = np.random.default_rng(2).normal(
        size=(4, HEIGHT, WIDTH, 6)).astype(np.float32)
    variables = {"params": enc_params, "batch_stats": enc_stats}
    feats_eval = jax.jit(lambda v, x: encoder.apply(v, x, train=False))(
        variables, pairs)
    feats_train = jax.jit(lambda v, x: encoder.apply(
        v, x, train=True, mutable=["batch_stats"])[0])(variables, pairs)
    head = JaxPoseHead()
    head_params, _ = _flax_init(head, feats_eval)
    return (enc_params, enc_stats, head_params, pairs,
            [np.asarray(f) for f in feats_eval],
            [np.asarray(f) for f in feats_train])


def _pose_encoder(enc_params, enc_stats):
    ours = make_pose_encoder(18, num_input_images=2)
    ours.load_state_dict(from_jax.resnet_encoder(enc_params, enc_stats, 18),
                         strict=True)
    return ours


def test_pose_encoder_matches_flax(pose_net):
    enc_params, enc_stats, _, pairs, ref_eval, _ = pose_net
    ours = _pose_encoder(enc_params, enc_stats).eval()
    assert ours.encoder.conv1.weight.shape == (64, 6, 7, 7)
    with torch.no_grad():
        feats = ours(torch.from_numpy(pairs).permute(0, 3, 1, 2))
    for level, (f, r) in enumerate(zip(feats, ref_eval)):
        _assert_close(_nhwc(f), r, f"pose encoder level {level}")


def test_train_mode_batch_norm_keeps_running_stats(pose_net):
    """Train mode normalizes with the batch's statistics, as Flax's
    ``train=True`` does, and leaves every running statistic and counter
    bit-unchanged; eval mode afterwards still uses them."""
    enc_params, enc_stats, _, pairs, ref_eval, ref_train = pose_net
    ours = keep_running_stats(_pose_encoder(enc_params, enc_stats))
    before = {k: v.clone() for k, v in ours.state_dict().items()}
    x = torch.from_numpy(pairs).permute(0, 3, 1, 2)
    ours.train()
    with torch.no_grad():
        feats = ours(x)
    for level, (f, r) in enumerate(zip(feats, ref_train)):
        _assert_close(_nhwc(f), r, f"train-mode level {level}")
    for key, value in ours.state_dict().items():
        assert torch.equal(value, before[key]), key
    ours.eval()
    with torch.no_grad():
        _assert_close(_nhwc(ours(x)[-1]), ref_eval[-1], "eval after train")


def test_make_encoder_rejects_deep_multi_image_encoders():
    with pytest.raises(ValueError, match="ResNet-18 or ResNet-50"):
        make_pose_encoder(101, num_input_images=2)


@pytest.mark.parametrize("invert", [False, True])
def test_pose_head_matches_flax(pose_net, invert):
    _, _, head_params, _, feats, _ = pose_net
    ref = JaxPoseHead().apply({"params": head_params}, feats,
                              invert_pose=invert)
    ours = PoseHead((64, 64, 128, 256, 512)).eval()
    ours.load_state_dict(from_jax.pose_head(head_params), strict=True)
    assert ours.net[-1].weight.shape[0] == 12
    with torch.no_grad():
        transform = ours(_torch_feats(feats), invert_pose=invert)
    assert transform.shape == (feats[0].shape[0], 4, 4)
    _assert_close(transform.numpy(), ref, "pose transform")


def test_bridge_round_trips_pose_modules(pose_net):
    """The pose encoder and head go through the bridge and the JAX
    package's converter and come back bit for bit."""
    enc_params, enc_stats, head_params, _, _, _ = pose_net
    cfg = jax_cfg_defaults()
    params = {"backbone_pose_sflow": enc_params, "pose_head": head_params}
    stats = {"backbone_pose_sflow": enc_stats}
    state_dicts = from_jax.state_dicts_from_jax(params, stats, cfg)
    assert set(state_dicts) == set(params)
    back_params, back_stats = convert_checkpoint(
        {"state_dict": state_dicts}, cfg)
    for tree, back in ((params, back_params), (stats, back_stats)):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(back_flat)
        for path, leaf in flat:
            assert np.array_equal(leaf, back_flat[path]), path
