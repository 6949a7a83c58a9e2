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

The pose network's tests are in ``tests/test_torch_models_pose.py``
(a file holds under 13 tests); the shared helpers in
``tests/torch_model_cases.py``.
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
from codeps_tpu.models.heads import SemanticHead as JaxSemanticHead
from codeps_tpu.models.resnet import make_encoder

from codeps_torch.io import from_jax
from codeps_torch.models.heads import DepthHead, InstanceHead, SemanticHead
from codeps_torch.models.resnet import ResNetEncoder
from torch_model_cases import (HEIGHT, NUM_CLASSES, WIDTH, _assert_close,
                               _flax_init, _nhwc, _torch_feats)
from torch_model_cases import few_threads  # noqa: F401 (autouse)



@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


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


