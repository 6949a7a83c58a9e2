"""The port's scene-flow path against the JAX package on the same weights,
inputs and automask noise.

Covered: ``FlowHead`` (also its state dict through
``codeps_tpu.io.convert_pth.convert_flow_head``, the reference ``.pth``
layout), ``encode_frames`` and ``depth_forward`` with flow in train mode,
both flow losses, ``resize_nearest``, ``reconstruction_loss_semantic``,
``semantic_consistency_loss`` with JAX's identity noise injected, one
flow adaptation step (the setup of ``tests/test_adapt_step.py``, as in
``test_torch_adapt.py``, with the flow head live, semantic and instance
heads on and target replay), one flow train step at 64x96 with a live
depth encoder, and the flow head in bfloat16. Weights go from JAX to the
port through ``codeps_torch.io.from_jax``; every comparison is in
float32 but the 3B pass's gradient (float64) and the last (bfloat16).
One JAX compile of each step serves its tests (module fixtures).

Tolerances, each with its reason:
  - the auto-mask keeps a pixel whose motion norm is strictly above the
    batch's mean norm; oneDNN and XLA sum the convolutions in different
    orders, so pixels within TIE_BAND (relative) of the mean may fall on
    either side. The masks must be equal outside that band, and the band
    must hold under 2% of the pixels;
  - flow values: 1e-5 absolute (the maps are about 1e-3), on the pixels
    both sides keep. The two steps run with the auto-mask off on both
    sides: a pixel that crosses the mean moves a step's gradients by its
    own share (one pixel of a 64x96 train step moved the flow head's by
    1.3e-3 of its largest), so they are compared on the pre-mask path,
    as tests/test_models.py:84 compares the head;
  - losses: relative 1e-4 (test_torch_adapt.py, test_torch_train.py);
  - the adaptation step's gradients: 1e-4 of the module's largest
    gradient for the heads (test_torch_train.py's bound; measured 3.3e-5
    on the flow head, 2.0e-5 on the pose head, under 1.4e-6 on the
    others) and 2.5e-4 for the pose net (measured 1.4e-4, on conv1), the
    bound test_torch_train.py gives the instance head for the same
    reason: its train-mode BatchNorm sees 4 elements a channel at layer4
    (a 32x64 target, 2 pairs), which amplifies the float noise of the
    forward;
  - the train step's parameters and BatchNorm statistics: those of
    test_torch_train.py's first step (parameters within 2.2 lr,
    statistics 1e-5 of the tensor's largest plus 1e-5). Its gradients:
    relative L2 error over the module 1e-4 for the semantic head (no
    normalization layer; measured 6.7e-6) and 1e-2 for the others
    (measured: pose net 3.1e-3, instance head 6.3e-3, depth, pose and
    flow heads 1.3e-4). Train-mode BatchNorm at these shapes amplifies
    the encoders' float differences (1e-5 of their largest feature)
    some hundredfold: on equal features the instance head agrees to
    1e-6, on each side's own 3B features to 3.4e-3 of its largest
    gradient; the RGB-D pose input carries the depth head's differences
    into the pose net's BatchNorm. Three separate encoder passes in
    place of the 3B pass give 0.04-1.3;
  - the 3B pass's encoder gradient through its batch statistics, in
    float64 on both sides: relative L2 error 1e-10 (measured 1.1e-14;
    separate passes 0.8);
  - the nearest resize and the argmax labels: exact;
  - bfloat16: the rule of test_torch_precision.py, no farther from the
    JAX package's bfloat16 than twice its own bfloat16-to-float32
    distance.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.config import get_cfg_defaults as jax_cfg_defaults
from codeps_tpu.io.convert_pth import convert_flow_head
from codeps_tpu.losses import flow_smoothness_loss as jax_flow_smoothness
from codeps_tpu.losses import flow_sparsity_loss as jax_flow_sparsity
from codeps_tpu.losses import (
    reconstruction_loss_semantic as jax_reconstruction_loss_semantic)
from codeps_tpu.losses import (
    semantic_consistency_loss as jax_semantic_consistency_loss)
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.models.heads import FlowHead as JaxFlowHead
from codeps_tpu.ops.resize import resize_nearest as jax_resize_nearest
from codeps_tpu.tasks import TrainState as JaxTrainState
from codeps_tpu.tasks import build_optimizer as jax_build_optimizer
from codeps_tpu.tasks import make_adapt_state as jax_make_adapt_state
from codeps_tpu.tasks import make_train_step as jax_make_train_step
from codeps_tpu.tasks.adapt import build_eval_forward as jax_eval_forward
from codeps_tpu.tasks.adapt import make_adapt_step as jax_make_adapt_step
from codeps_tpu.tasks.forward import depth_forward as jax_depth_forward
from codeps_tpu.tasks.forward import encode_frames as jax_encode_frames

from codeps_torch.config import gen_config, get_cfg_defaults
from codeps_torch.io import from_jax
from codeps_torch.losses import (flow_smoothness_loss, flow_sparsity_loss,
                                 reconstruction_loss_semantic,
                                 semantic_consistency_loss)
from codeps_torch.models import build_modules
from codeps_torch.models.heads import FlowHead
from codeps_torch.models.resnet import keep_running_stats
from codeps_torch.ops.resize import resize_nearest
from codeps_torch.tasks.adapt import build_eval_forward, make_adapt_step
from codeps_torch.tasks.forward import depth_forward, encode_frames
from codeps_torch.tasks.state import (make_adapt_state, make_train_state,
                                      match_prefixes)
from codeps_torch.tasks.train import make_train_step

NC = 14
THINGS = (9, 10, 11, 12, 13)
POSE_CH = (64, 64, 128, 256, 512)
NUM_SCALES = 5
LR = 1e-4
TIE_BAND = 1e-4
TIE_SHARE = 0.02
FLOW_ATOL = 1e-5
REL_TOL = 1e-4
ADAPT_GRAD_TOL = 1e-4
POSE_NET_GRAD_TOL = 2.5e-4
TRAIN_GRAD_TOL = 1e-2
SEMANTIC_GRAD_TOL = 1e-4
# the adaptation step: tests/test_adapt_step.py's sizes and freezing
HT, WT = 32, 64
HS, WS = 32, 96
NUM_SOURCE = NUM_REPLAY = NUM_MIXUP = 2
FROZEN = ("backbone_po_depth", "instance_head")
EMA = ("semantic_head",)
LIVE = ("backbone_pose_sflow", "depth_head", "pose_head", "flow_head",
        "semantic_head")
# the train step: tests/test_train_step.py's size
H, W = 64, 96
B = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _check_motion(ours, ref, what):
    """Two auto-masked motion batches, (B, H, W, 3) numpy maps: a pixel
    kept by one side only must lie in the tie band above that side's
    threshold (its smallest kept norm), such pixels must be under
    TIE_SHARE, and where both keep a pixel the values agree within
    FLOW_ATOL."""
    kept = [np.any(m != 0, axis=-1) for m in (ours, ref)]
    differ = kept[0] != kept[1]
    for m, k in zip((ours, ref), kept):
        norm = np.sqrt((m * m).sum(-1))
        floor = norm[k].min()
        assert np.all(norm[differ & k] <= floor * (1 + TIE_BAND)), what
    assert differ.mean() <= TIE_SHARE, (what, differ.mean())
    both = kept[0] & kept[1]
    assert 0.05 < both.mean() < 0.95, (what, both.mean())
    err = np.abs(ours[both] - ref[both]).max()
    assert err <= FLOW_ATOL, (what, err)
    return differ.sum(), err


def _pose_pyramid(rng, batch, height, width):
    """A pose-net pyramid (B, H/2**(i+1), W/2**(i+1), C) of normals."""
    return [rng.normal(0, 1, (batch, height >> (i + 1), width >> (i + 1),
                              c)).astype(np.float32)
            for i, c in enumerate(POSE_CH)]


def test_flow_head_matches_jax():
    """At 32x64 the coarsest features are 1 pixel high (jnp.pad's reflect
    repeats it) and at 64x96 2 high; the port's state dict converts to
    the JAX tree through the reference ``.pth`` reader, key for key."""
    rng = np.random.default_rng(0)
    jhead = JaxFlowHead(num_ch_enc=POSE_CH)
    for height, width in ((HT, WT), (H, W)):
        feats = _pose_pyramid(rng, 2, height, width)
        params = jax.tree.map(np.array, jhead.init(
            jax.random.PRNGKey(height), feats)["params"])
        head = FlowHead(POSE_CH)
        head.load_state_dict(from_jax.flow_head(params), strict=True)
        back = convert_flow_head(head.state_dict())
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
        ref = np.asarray(jax.jit(jhead.apply)({"params": params}, feats))
        with torch.no_grad():
            ours = _nhwc(head([_nchw(f) for f in feats]))
        assert ours.shape == ref.shape == (2, height, width, 3)
        _check_motion(ours, ref, f"flow head {height}x{width}")


def _flow_modules():
    """JAX modules of a flow config (ResNet-18 encoders, depth and pose
    only) and their seeded weights, and the port's modules from them."""
    jcfg = jax_cfg_defaults()
    pcfg = get_cfg_defaults()
    for cfg in (jcfg, pcfg):
        cfg.model.make_sflow = True
        cfg.model.make_semantic = cfg.model.make_instance = False
        cfg.model.po_depth_net.params.nof_layers = 18
        cfg.tpu.compute_dtype = "float32"
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    params, stats = jax_init_params(jax.random.PRNGKey(3), jmodules, (H, W))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    modules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg)
    assert tuple(modules.backbone_pose_sflow.encoder.conv1.weight.shape) \
        == (64, 8, 7, 7)
    return jmodules, params, stats, modules, pcfg


def test_encode_frames_and_depth_forward_match():
    """Train mode: one 3B encoder pass (its batch statistics move the
    running ones), the neighbours' depth, the RGB-D pose pairs and the
    flow head once per pair."""
    jmodules, params, stats, modules, cfg = _flow_modules()
    rng = np.random.default_rng(1)
    frames = rng.normal(0, 1, (B, 3, H, W, 3)).astype(np.float32)
    @jax.jit
    def jax_forward(frames):
        per_frame, enc_stats = jax_encode_frames(jmodules, params, stats,
                                                 frames, train=True)
        return per_frame, enc_stats, jax_depth_forward(
            jmodules, params, stats, [frames[:, i] for i in range(3)],
            per_frame[0], train=True, feats_neighbors=per_frame[1:])
    per_frame, enc_stats, jfwd = jax_forward(jnp.asarray(frames))
    modules.train()
    images = [_nchw(frames[:, i]) for i in range(3)]
    with torch.no_grad():
        feats = encode_frames(modules.backbone_po_depth, images)
        fwd = depth_forward(modules, images, feats[0], feats[1:])
    for i in range(3):
        for ours, ref in zip(feats[i], per_frame[i]):
            ref = np.asarray(ref)
            err = np.abs(_nhwc(ours) - ref).max()
            assert err <= REL_TOL * np.abs(ref).max(), (i, err)
    ref_sd = from_jax.state_dicts_from_jax(
        params, {**stats, "backbone_po_depth": enc_stats,
                 "backbone_pose_sflow": jfwd["pose_batch_stats"]}, cfg)
    for name in ("backbone_po_depth", "backbone_pose_sflow"):
        for key, value in getattr(modules, name).state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                ref = ref_sd[name][key].numpy()
                err = np.abs(value.numpy() - ref).max()
                assert err <= 1e-5 * np.abs(ref).max() + 1e-5, (key, err)
    err = np.abs(_nhwc(fwd["depth"]) - np.asarray(jfwd["depth"])).max()
    assert err <= REL_TOL * np.asarray(jfwd["depth"]).max(), err
    for ours, ref in zip(fwd["transformations"], jfwd["transformations"]):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    for i, (ours, ref) in enumerate(zip(fwd["object_motion_maps"],
                                        jfwd["object_motion_maps"])):
        _check_motion(_nhwc(ours), np.asarray(ref), f"motion {i}")

    # The gradient couples frame t to its neighbours through the batch
    # statistics. In float64 on both sides, so that the two agree to
    # rounding: in float32 train-mode BatchNorm amplifies the rounding
    # to 8e-3 of this gradient (separate passes: 0.8).
    with jax.enable_x64(True):
        encoder64 = dataclasses.replace(jmodules.backbone_po_depth,
                                        dtype=jnp.float64)
        jmodules64 = dataclasses.replace(jmodules,
                                         backbone_po_depth=encoder64)
        params64, stats64 = jax.tree.map(
            lambda a: np.asarray(a, np.float64), (params, stats))
        frames64 = jnp.asarray(frames, jnp.float64)
        weights = [rng.normal(0, 1, np.asarray(f).shape[1:])
                   for f in per_frame[0]]

        def jax_loss(p):
            feats, _ = jax_encode_frames(
                jmodules64, {**params64, "backbone_po_depth": p}, stats64,
                frames64, train=True)
            return sum(jnp.sum(f * w) for f, w in zip(feats[0], weights))
        jgrad = from_jax.resnet_encoder(
            jax.tree.map(np.array, jax.jit(jax.grad(jax_loss))(
                params64["backbone_po_depth"])),
            stats64["backbone_po_depth"], 18)
    encoder = keep_running_stats(copy.deepcopy(
        modules.backbone_po_depth).double().train())
    images64 = [_nchw(frames[:, i].astype(np.float64)) for i in range(3)]

    def rel_l2(encode):
        encoder.zero_grad()
        feats = encode(encoder, images64)
        sum((f * _nchw(w[None])).sum()
            for f, w in zip(feats[0], weights)).backward()
        num = den = 0.0
        for key, p in encoder.named_parameters():
            num += float(((p.grad.numpy() - jgrad[key].numpy()) ** 2).sum())
            den += float((jgrad[key].numpy() ** 2).sum())
        return np.sqrt(num / den)
    err = rel_l2(encode_frames)
    apart = rel_l2(lambda enc, ims: [enc(im) for im in ims])
    assert err <= 1e-10, err
    assert apart > 0.1, apart


def test_flow_losses_match():
    """Both losses, with and without wrap-around, on auto-masked maps,
    and their gradients; the sparsity's spatial mean is a constant for
    the gradient. At an exact 0 jax.grad of abs is 1 and torch's 0 (the
    reference's): the gradients are compared on maps without zeros (the
    flow head's mask multiplies the gradient of a masked pixel by 0
    anyway)."""
    rng = np.random.default_rng(2)
    dense = [rng.normal(0, 1e-3, (B, 16, 24, 3)).astype(np.float32)
             for _ in range(2)]
    masked = [m * (rng.random((B, 16, 24, 1)) < 0.5) for m in dense]
    for wrap in (True, False):
        for maps in (masked, dense):
            ours = [_nchw(m).requires_grad_() for m in maps]
            smth = flow_smoothness_loss(ours, wrap_around=wrap)
            sparsity = flow_sparsity_loss(ours)
            np.testing.assert_allclose(
                smth.item(), float(jax_flow_smoothness(maps, wrap)),
                rtol=1e-6)
            np.testing.assert_allclose(
                sparsity.item(), float(jax_flow_sparsity(maps)), rtol=1e-6)

        def jax_total(ms):
            return (jax_flow_smoothness(ms, wrap_around=wrap)
                    + 3.0 * jax_flow_sparsity(ms))
        jgrads = jax.grad(jax_total)([jnp.asarray(m) for m in dense])
        (smth + 3.0 * sparsity).backward()
        for ours_map, ref in zip(ours, jgrads):
            ref = np.asarray(ref)
            np.testing.assert_allclose(_nhwc(ours_map.grad), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())


def test_resize_nearest_matches():
    rng = np.random.default_rng(3)
    for (h, w), size in (((7, 13), (3, 5)), ((7, 13), (16, 29)),
                         ((64, 96), (32, 48)), ((370, 1226), (48, 160))):
        img = rng.normal(0, 1, (2, h, w, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            resize_nearest(torch.from_numpy(img), size).numpy(),
            np.asarray(jax_resize_nearest(jnp.asarray(img), size)))


def _warp_inputs(rng, batch, height, width):
    """Intrinsics, depth and two small poses of a target frame."""
    intrinsics = np.tile(np.asarray([[40.0, 40.0, width / 2, height / 2]],
                                    np.float32), (batch, 1))
    depth = rng.uniform(2.0, 30.0, (batch, height, width, 1)).astype(
        np.float32)
    poses = []
    for sign in (-1.0, 1.0):
        pose = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
        pose[:, :3, 3] = sign * rng.uniform(0.05, 0.3, (batch, 3))
        pose[:, 0, 1], pose[:, 1, 0] = 0.01 * sign, -0.01 * sign
        poses.append(pose)
    return intrinsics, depth, poses


def test_semantic_warp_losses_match():
    """``reconstruction_loss_semantic`` on label maps, and
    ``semantic_consistency_loss`` with and without motion maps and with
    ignored classes and class weights, JAX's identity normals injected
    into the port."""
    rng = np.random.default_rng(4)
    height, width = 32, 48
    intrinsics, depth, poses = _warp_inputs(rng, B, height, width)
    masks = [rng.integers(0, NC, (B, height, width)).astype(np.int32)
             for _ in range(3)]
    ref = jax_reconstruction_loss_semantic(intrinsics, masks, depth, poses,
                                           num_scales=3)
    ours = reconstruction_loss_semantic(
        _t(intrinsics), [_t(m) for m in masks], _nchw(depth),
        [_t(p) for p in poses], num_scales=3)
    np.testing.assert_allclose(float(ours), float(ref), rtol=REL_TOL)

    probs = [np.array(jax.nn.softmax(rng.normal(
        0, 2, (B, height, width, NC)).astype(np.float32), axis=-1))
        for _ in range(3)]
    # a tie in every sample: the argmax takes the lowest class
    for p in probs:
        p[:, 0, 0, :] = 1.0 / NC
    images = [rng.normal(0, 1, (B, height, width, 3)).astype(np.float32)
              for _ in range(3)]
    motion = [rng.normal(0, 0.05, (B, height, width, 3)).astype(np.float32)
              for _ in range(2)]
    for key, extra in ((0, {}),
                       (1, {"object_motion_maps": motion}),
                       (2, {"ignore_labels": [3],
                            "class_weights": list(np.linspace(0.5, 2, NC))})):
        jkey = jax.random.PRNGKey(key)
        ref = jax_semantic_consistency_loss(
            jkey, intrinsics, probs, images, depth, poses, **extra)
        draw = np.asarray(jax.random.normal(jkey, (B, height, width, 2)))
        port_extra = dict(extra)
        if "object_motion_maps" in extra:
            port_extra["object_motion_maps"] = [_nchw(m) for m in motion]

        def noise(shape, draw=draw):
            assert tuple(shape) == (B, 2, height, width)
            return _nchw(draw)
        ours = semantic_consistency_loss(
            _t(intrinsics), [_nchw(p) for p in probs],
            [_nchw(i) for i in images], _nchw(depth),
            [_t(p) for p in poses], noise=noise, **port_extra)
        np.testing.assert_allclose(float(ours), float(ref), rtol=REL_TOL,
                                   err_msg=str(key))


def _adapt_configure(cfg):
    cfg.model.make_sflow = True
    cfg.adapt.model.sflow = True
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.adapt.ema.semantic = True
    cfg.adapt.ema.alpha = 0.99
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _adapt_batch(seed):
    rng = np.random.default_rng(seed)

    def cams(n, h, w, f):
        return np.tile(np.asarray([[f, f, w / 2, h / 2]], np.float32),
                       (n, 1))

    def frames(n, h, w):
        return rng.integers(0, 256, (n, 3, h, w, 3), dtype=np.uint8)

    return {
        "target": {"frames": frames(1, HT, WT),
                   "camera": cams(1, HT, WT, 30.0)},
        "source": {
            "frames": frames(NUM_SOURCE, HS, WS),
            "camera": cams(NUM_SOURCE, HS, WS, 28.0),
            "semantic": rng.integers(0, NC, (NUM_SOURCE, HS, WS)).astype(
                np.int32),
            "semantic_weights": rng.uniform(
                0.5, 2.0, (NUM_SOURCE, HS, WS)).astype(np.float32),
            "center": rng.uniform(0, 1, (NUM_SOURCE, HS, WS, 1)).astype(
                np.float32),
            "offset": rng.normal(0, 4, (NUM_SOURCE, HS, WS, 2)).astype(
                np.float32),
        },
        "target_replay": {"frames": frames(NUM_REPLAY, HT, WT),
                          "camera": cams(NUM_REPLAY, HT, WT, 30.0)},
        "mixup": {
            "rgb": rng.integers(0, 256, (NUM_MIXUP, HS, WS, 3),
                                dtype=np.uint8),
            "semantic": rng.integers(0, NC, (NUM_MIXUP, HS, WS)).astype(
                np.int32),
        },
        "eval_gt": {
            "semantic": rng.integers(0, NC, (1, HT, WT)).astype(np.int32),
            "depth_gt": rng.uniform(1, 60, (1, HT, WT)).astype(np.float32),
        },
    }


def _scale_noise(key, batch, height, width):
    out = []
    for s in range(NUM_SCALES):
        key, sub = jax.random.split(key)
        draw = jax.random.normal(sub, (batch, height >> s, width >> s, 2),
                                 jnp.float32)
        out.append(np.asarray(draw).transpose(0, 3, 1, 2))
    return out


class Injected:
    """Hands out given arrays in order, checking the shapes asked for."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape):
        draw = self.arrays.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return torch.from_numpy(np.array(draw))


def adapt_step_noise(step_key):
    """The automask normals of one JAX flow step from ``state.rng``: the
    loss key's splits give the source, the target and the replay
    domain's keys in turn (``adapt.py:507, 537, 569``), one key a scale
    (``photometric.py:187``)."""
    _, key = jax.random.split(step_key)
    out = []
    for batch, height, width in ((NUM_SOURCE, HS, WS), (1, HT, WT),
                                 (NUM_REPLAY, HT, WT)):
        key, sub = jax.random.split(key)
        out += _scale_noise(sub, batch, height, width)
    return out


@pytest.fixture(scope="module")
def adapt_run():
    """One flow adaptation step on each side from the same weights,
    batch and noise, the auto-mask off on both sides (see train_run)."""
    jcfg = _adapt_configure(jax_gen_config(adapt=True, freeze=False))
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    jmodules = dataclasses.replace(jmodules, flow_head=dataclasses.replace(
        jmodules.flow_head, auto_mask=False))
    params, stats = jax_init_params(jax.random.PRNGKey(0), jmodules,
                                    (HT, WT))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    tx = jax_build_optimizer(jcfg, LR, frozen_modules=FROZEN)
    jstep = jax_make_adapt_step(
        jmodules, jcfg, tx, class_weights=[1.0] * NC, ema_modules=EMA,
        frozen_modules=FROZEN, has_replay=True, num_mixup=NUM_MIXUP,
        donate=False, eval_forward=jax_eval_forward(jmodules, jcfg, THINGS))
    js = jax_make_adapt_state(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        tx, jax.random.PRNGKey(2), ema_modules=EMA, frozen_modules=FROZEN,
        ema_alpha=0.99)
    batch = _adapt_batch(1)
    noise = adapt_step_noise(js.rng)
    js, *jres = jstep(js, jax.tree.map(jnp.asarray, batch))

    pcfg = _adapt_configure(gen_config(adapt=True, freeze=False))
    modules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg)
    modules.flow_head.auto_mask = False
    ps = make_adapt_state(modules, LR, ema_modules=EMA,
                          frozen_modules=FROZEN, ema_alpha=0.99,
                          device="cpu")
    pstep = make_adapt_step(pcfg, [1.0] * NC, has_replay=True,
                            num_mixup=NUM_MIXUP,
                            eval_forward=build_eval_forward(pcfg, THINGS, NC))
    injected = Injected(noise)
    pres = pstep(ps, batch, noise=injected)
    assert not injected.arrays
    grads = {name: {k: p.grad.clone() for k, p in
                    getattr(ps.student, name).named_parameters()}
             for name in LIVE}
    return {"params": params, "stats": stats, "cfg": pcfg,
            "jax": (jax.tree.map(np.array, js), jax.tree.map(np.array,
                                                             jres)),
            "port": (grads, pres)}


def test_flow_adapt_step_matches(adapt_run):
    """Losses (the flow terms included) and the student's target motion
    pair in the eval results."""
    _, (jmetrics, _, jresults, _) = adapt_run["jax"]
    _, (pmetrics, _, presults, _) = adapt_run["port"]
    assert set(pmetrics) == set(jmetrics)
    assert {"flow_smth", "flow_sparsity"} <= set(pmetrics)
    for key, ref in jmetrics.items():
        if key == "target_skipped":
            assert not bool(pmetrics[key]) and not bool(ref)
            continue
        ours, ref = float(pmetrics[key]), float(ref)
        assert abs(ours - ref) <= REL_TOL * abs(ref), (key, ours, ref)
    ours = presults["object_motion_map"].numpy()
    ref = jresults["object_motion_map"]
    assert ours.shape == ref.shape == (2, 1, HT, WT, 3)
    assert np.abs(ours - ref).max() <= FLOW_ATOL
    assert {k for k, v in presults.items() if v is not None} \
        == {k for k, v in jresults.items() if v is not None}


def _adam_mu(jstate, name):
    return jstate.opt_state.inner_states["trained"].inner_state[0].mu[name]


def test_flow_adapt_step_gradients_match(adapt_run):
    """Adam's first moment after one step from zero is 0.1 g."""
    jstate, _ = adapt_run["jax"]
    grads, _ = adapt_run["port"]
    for name in LIVE:
        ref = from_jax.state_dicts_from_jax(
            {name: _adam_mu(jstate, name)}, adapt_run["stats"],
            adapt_run["cfg"])[name]
        largest = max(float(np.abs(ref[key].numpy()).max()) / 0.1
                      for key in grads[name])
        assert largest > 0, name
        tol = (POSE_NET_GRAD_TOL if name == "backbone_pose_sflow"
               else ADAPT_GRAD_TOL)
        for key, grad in grads[name].items():
            err = float(np.abs(grad.numpy() - ref[key].numpy() / 0.1).max())
            assert err <= tol * largest, (name, key, err, largest)


def _train_configure(cfg):
    cfg.model.make_sflow = True
    cfg.model.instance_head.use_thing_mask = True
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.semantics.top_k = 0.2
    cfg.losses.weights.center = 20.0
    cfg.losses.weights.offset = 0.1
    cfg.losses.weights.thing_mask = 0.5
    cfg.dataset.feed_img_size = [H, W]
    cfg.tpu.compute_dtype = "float32"
    return cfg


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "frames": rng.integers(0, 256, (B, 3, H, W, 3), dtype=np.uint8),
        "camera": np.tile(np.asarray([[40.0, 40.0, W / 2, H / 2]],
                                     np.float32), (B, 1)),
        "semantic": rng.integers(0, NC, (B, H, W)).astype(np.int32),
        "semantic_weights": rng.uniform(0.5, 2.0, (B, H, W)).astype(
            np.float32),
        "center": rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32),
        "center_weights": np.ones((B, H, W, 1), np.float32),
        "offset": rng.normal(0, 4, (B, H, W, 2)).astype(np.float32),
        "offset_weights": np.ones((B, H, W, 1), np.float32),
        "thing_mask": rng.integers(0, 2, (B, H, W)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def train_run():
    """One flow train step on each side, the depth encoder frozen by the
    CLI's prefix rule as in test_torch_train.py (it still runs the one 3B
    train-mode pass whose statistics move its running ones), the flow
    head's auto-mask off on both sides (the module docstring says why;
    the masks are held in the tests of the head and of depth_forward)."""
    jcfg = _train_configure(jax_cfg_defaults())
    pcfg = _train_configure(get_cfg_defaults())
    jmodules = jax_build_modules(jcfg, num_classes=NC)
    jmodules = dataclasses.replace(jmodules, flow_head=dataclasses.replace(
        jmodules.flow_head, auto_mask=False))
    params, stats = jax_init_params(jax.random.PRNGKey(5), jmodules, (H, W))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    frozen = match_prefixes(sorted(params), ["backbone_po_"])
    tx = jax_build_optimizer(jcfg, LR, frozen_modules=frozen)
    jstep = jax_make_train_step(jmodules, jcfg, tx, class_weights=[1.0] * NC,
                                num_classes=NC, donate=False,
                                frozen_modules=frozen)
    js = JaxTrainState(params=jax.tree.map(jnp.asarray, params),
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(7))
    batch = _train_batch(10)
    # the step splits its key (train.py:215), the loss its half again
    # (:101), the loss one key a scale
    _, sub = jax.random.split(js.rng)
    _, key = jax.random.split(sub)
    noise = _scale_noise(key, B, H, W)
    js, jmetrics = jstep(js, jax.tree.map(jnp.asarray, batch))

    modules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg)
    modules.flow_head.auto_mask = False
    ps = make_train_state(modules, LR, frozen_modules=frozen, device="cpu")
    pmetrics = make_train_step(pcfg, [1.0] * NC, num_classes=NC)(
        ps, batch, noise=Injected(noise))
    live = ps.live_modules()
    return {
        "params": params, "stats": stats, "cfg": pcfg, "live": live,
        "jax": (jax.tree.map(np.array, js.params),
                jax.tree.map(np.array, js.batch_stats),
                [np.array(leaf) for leaf in jax.tree.leaves(js.opt_state)],
                jax.tree.map(np.array, jmetrics)),
        "port": ({name: {k: v.clone() for k, v in
                         getattr(modules, name).state_dict().items()}
                  for name in modules.module_names()},
                 {name: {k: p.grad.clone() for k, p in
                         getattr(modules, name).named_parameters()}
                  for name in live},
                 pmetrics)}


def test_flow_train_step_losses_and_statistics(train_run):
    """Losses and metrics within 1e-4; the running statistics (the depth
    encoder's from the one 3B pass) within 1e-5 of the tensor's largest
    plus 1e-5; the parameters after the Adam step within 2.2 lr."""
    jparams, jstats, _, jmetrics = train_run["jax"]
    ours_sd, _, pmetrics = train_run["port"]
    assert set(pmetrics) == set(jmetrics)
    assert {"flow_smth", "flow_sparsity"} <= set(pmetrics)
    for key, ref in jmetrics.items():
        if key == "sem_conf":
            np.testing.assert_array_equal(pmetrics[key].numpy(), ref)
            continue
        ours, ref = float(pmetrics[key]), float(ref)
        assert abs(ours - ref) <= REL_TOL * abs(ref), (key, ours, ref)
    ref_sd = from_jax.state_dicts_from_jax(jparams, jstats, train_run["cfg"])
    init = from_jax.state_dicts_from_jax(train_run["params"],
                                         train_run["stats"], train_run["cfg"])
    assert "flow_head" in ref_sd
    for name, sd in ours_sd.items():
        for key, value in sd.items():
            expected = ref_sd[name][key].numpy()
            if key.endswith("num_batches_tracked"):
                assert int(value) == 1, (name, key)
            elif key.endswith(("running_mean", "running_var")):
                err = np.abs(value.numpy() - expected).max()
                bound = 1e-5 * np.abs(expected).max() + 1e-5
                assert err <= bound, (name, key, err, bound)
                assert not np.array_equal(value.numpy(),
                                          init[name][key].numpy())
            elif name in train_run["live"]:
                err = np.abs(value.numpy() - expected).max()
                assert err <= 2.2 * LR, (name, key, err)
            else:
                np.testing.assert_array_equal(value.numpy(), expected)


def test_flow_train_step_gradients_match(train_run):
    """Adam's first moment after one step from zero is 0.1 g (optax's
    leaves: count, mu over the live modules, nu)."""
    params, stats = train_run["params"], train_run["stats"]
    live = train_run["live"]
    assert live == ["backbone_pose_sflow", "depth_head", "pose_head",
                    "flow_head", "semantic_head", "instance_head"]
    _, _, leaves, _ = train_run["jax"]
    _, grads, _ = train_run["port"]
    trained = {name: params[name] for name in live}
    flat, treedef = jax.tree.flatten(trained)
    mu = jax.tree.unflatten(treedef, leaves[1:1 + len(flat)])
    ref = from_jax.state_dicts_from_jax(
        jax.tree.map(lambda m: m / 0.1, mu), stats, train_run["cfg"])
    for name, module_grads in grads.items():
        num = den = 0.0
        for key, grad in module_grads.items():
            num += float(((grad.numpy() - ref[name][key].numpy()) ** 2).sum())
            den += float((ref[name][key].numpy() ** 2).sum())
        err = np.sqrt(num / den)
        tol = (SEMANTIC_GRAD_TOL if name == "semantic_head"
               else TRAIN_GRAD_TOL)
        print(f"{name}: relative L2 error {err:.3g}")
        assert err <= tol, (name, err, tol)


def test_flow_head_in_bfloat16():
    """The rule of test_torch_precision.py on the flow head's output
    (max absolute difference), before and after the auto-mask."""
    rng = np.random.default_rng(6)
    feats = _pose_pyramid(rng, B, H, W)
    params = jax.tree.map(np.array, JaxFlowHead(num_ch_enc=POSE_CH).init(
        jax.random.PRNGKey(6), feats)["params"])
    head = FlowHead(POSE_CH)
    head.load_state_dict(from_jax.flow_head(params), strict=True)
    for auto_mask in (False, True):
        head.auto_mask = auto_mask
        out = {}
        for name, jdtype, tdtype in (("bfloat16", jnp.bfloat16,
                                      torch.bfloat16),
                                     ("float32", jnp.float32,
                                      torch.float32)):
            jhead = JaxFlowHead(num_ch_enc=POSE_CH, auto_mask=auto_mask,
                                dtype=jdtype)
            head.compute_dtype = tdtype
            with torch.no_grad():
                ours = _nhwc(head([_nchw(f) for f in feats]))
            assert ours.dtype == np.float32
            ref = jax.jit(jhead.apply)({"params": params}, feats)
            out[name] = (ours, np.asarray(ref))
        ours, ref = out["bfloat16"]
        ours_f32, ref_f32 = out["float32"]
        jax_distance = np.abs(ref - ref_f32).max()
        assert jax_distance > 0
        assert not np.array_equal(ours, ours_f32)
        assert np.abs(ours - ref).max() <= 2 * jax_distance, auto_mask
