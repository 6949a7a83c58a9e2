"""The port's encoder and heads against Flax ``apply`` on the same
weights, and the weight bridge against the JAX package's own converter.

Weights are the Flax modules' own initialization, with the BatchNorm
statistics and the biases redrawn from a seeded numpy generator so that
no layer is an identity. They reach the port through
``codeps_torch.io.from_jax``. Inputs come from
``numpy.random.default_rng``; everything runs on the CPU in float32.

The pose network (6-channel ResNet-18 and pose head) is compared the
same way, its encoder also in train mode, where BatchNorm normalizes
with the batch's statistics: Flax takes the variance as E[x^2] - E[x]^2,
torch in two passes, well inside the tolerance at these sizes.

Tolerance: max abs error <= 1e-4 * max|ref|. oneDNN and XLA sum the
convolutions in different orders, and the differences grow through deep
conv stacks. Largest errors seen, relative to
max|ref|: encoder levels 1.2e-6 (ResNet-18) and 2.1e-6 (ResNet-50);
disparity 2.4e-6, depth 3.1e-6; semantic 2.3e-5 with GUDA fusion (the
resize's float32 source coordinate, see test_torch_ops.py) and 2.9e-6
without; center 1.8e-6, offset 1.9e-6, thing mask 8.1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import get_cfg_defaults_adapt as jax_cfg_defaults
from codeps_tpu.io.convert_pth import convert_checkpoint
from codeps_tpu.models.heads import DepthHead as JaxDepthHead
from codeps_tpu.models.heads import InstanceHead as JaxInstanceHead
from codeps_tpu.models.heads import PoseHead as JaxPoseHead
from codeps_tpu.models.heads import SemanticHead as JaxSemanticHead
from codeps_tpu.models.resnet import make_encoder

from codeps_torch.io import from_jax
from codeps_torch.models.heads import (DepthHead, InstanceHead, PoseHead,
                                       SemanticHead)
from codeps_torch.models.resnet import ResNetEncoder, keep_running_stats
from codeps_torch.models.resnet import make_encoder as make_pose_encoder

HEIGHT, WIDTH = 64, 128
NUM_CLASSES = 14
REL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _perturb(tree, rng, path=()):
    """Redraw BatchNorm statistics/affines and conv biases in place."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _perturb(value, rng, path + (key,))
            continue
        shape = value.shape
        if key == "mean":
            tree[key] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif key == "scale":
            tree[key] = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif key == "bias":
            tree[key] = rng.normal(0, 0.05, shape).astype(np.float32)
    return tree


def _flax_init(module, *args, **kwargs):
    variables = jax.jit(lambda key: module.init(key, *args, **kwargs))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.array, variables)
    rng = np.random.default_rng(11)
    params = _perturb(variables["params"], rng)
    stats = _perturb(variables.get("batch_stats", {}), rng)
    return params, stats


def _assert_close(ours, ref, what):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = REL_TOL * float(np.abs(ref).max())
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module", params=[18, 50])
def encoder(request):
    """(num_layers, flax module, params, stats, image, flax pyramid)."""
    num_layers = request.param
    module = make_encoder(num_layers)
    image = np.random.default_rng(0).normal(
        size=(2, HEIGHT, WIDTH, 3)).astype(np.float32)
    params, stats = _flax_init(module, jnp.zeros((1, HEIGHT, WIDTH, 3)),
                               train=False)
    feats = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, image)
    return (num_layers, module, params, stats, image,
            [np.asarray(f) for f in feats])


def test_encoder_pyramid_matches_flax(encoder):
    num_layers, _, params, stats, image, ref = encoder
    ours = ResNetEncoder(num_layers).eval()
    ours.load_state_dict(from_jax.resnet_encoder(params, stats, num_layers),
                         strict=True)
    assert ours.num_ch_enc == tuple(f.shape[-1] for f in ref)
    with torch.no_grad():
        feats = ours(torch.from_numpy(image).permute(0, 3, 1, 2))
    for level, (f, r) in enumerate(zip(feats, ref)):
        _assert_close(_nhwc(f), r, f"ResNet-{num_layers} level {level}")


@pytest.fixture(scope="module")
def resnet50_features():
    rng = np.random.default_rng(1)
    module = make_encoder(50)
    params, stats = _flax_init(module, jnp.zeros((1, HEIGHT, WIDTH, 3)),
                               train=False)
    image = rng.normal(size=(2, HEIGHT, WIDTH, 3)).astype(np.float32)
    feats = jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, image)
    return [np.asarray(f) for f in feats]


@pytest.fixture(scope="module")
def heads(resnet50_features):
    """Flax depth, GUDA semantic and instance heads initialized on the
    ResNet-50 pyramid: {name: (flax module, params, stats)}."""
    feats = [jnp.asarray(f) for f in resnet50_features]
    num_ch_enc = tuple(f.shape[-1] for f in feats)
    out = {}
    for name, module in (
            ("depth_head", JaxDepthHead(num_ch_enc=num_ch_enc)),
            ("semantic_head", JaxSemanticHead(
                num_ch_enc=num_ch_enc, num_classes=NUM_CLASSES,
                use_guda_fusion=True)),
            ("instance_head", JaxInstanceHead(num_ch_enc=num_ch_enc))):
        kwargs = {"train": False} if name == "instance_head" else {}
        out[name] = (module, *_flax_init(module, feats, **kwargs))
    return out


def test_bridge_round_trips_through_convert_checkpoint(encoder, heads,
                                                       resnet50_features):
    """JAX trees -> port state dicts -> the JAX package's converter gives
    back the original trees bit for bit, and the port's modules load
    them strictly and hold them unchanged. The heads are those of the
    ResNet-50 pyramid for both encoders: the converter reads names and
    layouts, not widths."""
    num_layers, _, params, stats, _, _ = encoder
    cfg = jax_cfg_defaults()
    cfg.model.po_depth_net.params.nof_layers = num_layers
    all_params = {"backbone_po_depth": params}
    all_stats = {"backbone_po_depth": stats}
    for name, (_, head_params, head_stats) in heads.items():
        all_params[name] = head_params
        if head_stats:
            all_stats[name] = head_stats

    state_dicts = from_jax.state_dicts_from_jax(all_params, all_stats, cfg)
    back_params, back_stats = convert_checkpoint(
        {"state_dict": state_dicts}, cfg)

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), (path, set(a) ^ set(b))
            for key in a:
                same(a[key], b[key], f"{path}/{key}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(a, b), path

    same(all_params, back_params, "params")
    same(all_stats, back_stats, "batch_stats")

    num_ch_enc = tuple(f.shape[-1] for f in resnet50_features)
    modules = {"backbone_po_depth": ResNetEncoder(num_layers),
               "depth_head": DepthHead(num_ch_enc),
               "semantic_head": SemanticHead(num_ch_enc, NUM_CLASSES,
                                             use_guda_fusion=True),
               "instance_head": InstanceHead(num_ch_enc)}
    for name, module in modules.items():
        module.load_state_dict(state_dicts[name], strict=True)
        for key, value in module.state_dict().items():
            assert torch.equal(value, state_dicts[name][key]), (name, key)


def _torch_feats(feats):
    return [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats]


def test_depth_head_matches_flax(resnet50_features, heads):
    feats = resnet50_features
    num_ch_enc = tuple(f.shape[-1] for f in feats)
    module, params, _ = heads["depth_head"]
    ref_depth, ref_disp = module.apply({"params": params}, feats)
    ours = DepthHead(num_ch_enc).eval()
    ours.load_state_dict(from_jax.depth_head(params), strict=True)
    with torch.no_grad():
        depth, disp = ours(_torch_feats(feats))
    assert depth.dtype == disp.dtype == torch.float32
    _assert_close(_nhwc(disp), ref_disp, "disparity")
    _assert_close(_nhwc(depth), ref_depth, "depth")


@pytest.mark.parametrize("use_guda_fusion", [True, False])
def test_semantic_head_matches_flax(resnet50_features, heads,
                                    use_guda_fusion):
    feats = resnet50_features
    num_ch_enc = tuple(f.shape[-1] for f in feats)
    if use_guda_fusion:
        module, params, _ = heads["semantic_head"]
    else:
        module = JaxSemanticHead(num_ch_enc=num_ch_enc,
                                 num_classes=NUM_CLASSES)
        params, _ = _flax_init(module, [jnp.asarray(f) for f in feats])
    ref = module.apply({"params": params}, feats)
    ours = SemanticHead(num_ch_enc, NUM_CLASSES,
                        use_guda_fusion=use_guda_fusion).eval()
    ours.load_state_dict(from_jax.semantic_head(params, use_guda_fusion),
                         strict=True)
    with torch.no_grad():
        sem = ours(_torch_feats(feats))
    assert sem.dtype == torch.float32
    _assert_close(_nhwc(sem), ref, "semantic probabilities")


@pytest.mark.parametrize("use_thing_mask", [False, True])
def test_instance_head_matches_flax(resnet50_features, heads,
                                    use_thing_mask):
    feats = resnet50_features
    num_ch_enc = tuple(f.shape[-1] for f in feats)
    if use_thing_mask:
        module = JaxInstanceHead(num_ch_enc=num_ch_enc, use_thing_mask=True)
        params, stats = _flax_init(module, [jnp.asarray(f) for f in feats],
                                   train=False)
    else:
        module, params, stats = heads["instance_head"]
    ref = module.apply({"params": params, "batch_stats": stats}, feats,
                       train=False)
    ours = InstanceHead(num_ch_enc, use_thing_mask=use_thing_mask).eval()
    ours.load_state_dict(
        from_jax.instance_head(params, stats, use_thing_mask), strict=True)
    with torch.no_grad():
        center, offset, thing_mask = ours(_torch_feats(feats))
    _assert_close(_nhwc(center), ref[0], "center")
    _assert_close(_nhwc(offset), ref[1], "offset")
    if use_thing_mask:
        _assert_close(_nhwc(thing_mask), ref[2], "thing mask")
    else:
        assert thing_mask is None and ref[2] is None


# ---- the pose network (training path)

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
