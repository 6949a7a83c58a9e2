"""``cfg.tpu.compute_dtype: bfloat16`` in the port against the JAX
package's bfloat16 modules and losses.

The JAX package builds its modules with ``dtype=bfloat16`` by default
(``codeps_tpu/config/defaults.py:263``, ``scripts/train.py:149-151``) and
runs the photometric image math and the semantic log-softmax in the same
dtype (``losses/photometric.py:106-180``, ``losses/semantic.py:82-103``).
Here the same seeded weights and inputs go through each module (encoder,
depth, semantic, pose and instance heads, eval mode), through
``reconstruction_loss`` and ``semantic_loss`` at their bfloat16 ``dtype``,
and through the pretraining loss (train mode, no gradient) on a few
batches, on both sides. ResNet-18 at 64x96, batch 2, 14 classes.

The tolerance is derived, not chosen: bfloat16 rounds differently in
oneDNN and XLA, so the port's bfloat16 result may be no farther from the
JAX bfloat16 result than twice the JAX package's own distance between its
bfloat16 and float32 results on the same inputs (max absolute difference
over a tensor; for a loss, absolute differences summed over the
batches). That distance must not be
0: it shows that bfloat16 changed the result. The port's own float32
result must differ from its bfloat16 one too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from codeps_tpu.config import get_cfg_defaults as jax_cfg_defaults
from codeps_tpu.losses import reconstruction_loss as jax_reconstruction_loss
from codeps_tpu.losses import semantic_loss as jax_semantic_loss
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params
from codeps_tpu.tasks.forward import apply_encoder as jax_apply_encoder
from codeps_tpu.tasks.train import make_loss_fn as jax_make_loss_fn

from codeps_torch.config import get_cfg_defaults
from codeps_torch.io import from_jax
from codeps_torch.losses import reconstruction_loss, semantic_loss
from codeps_torch.models import build_modules
from codeps_torch.tasks.train import make_loss_fn

H, W = 64, 96
B = 2
NC = 14
NUM_SCALES = 5
LOSS_BATCHES = 4
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, dtype):
    cfg.model.instance_head.use_thing_mask = True
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.model.pose_sflow_net.params.nof_layers = 18
    cfg.semantics.class_weights = [1.0] * NC
    cfg.dataset.feed_img_size = [H, W]
    cfg.tpu.compute_dtype = dtype
    return cfg


def _check(ours, ref_bf16, ref_f32, ours_f32, what, summed=False):
    """The rule; ``summed`` sums the distances of a series of scalars
    where the others take the maximum over a tensor."""
    ours, ref_bf16 = np.asarray(ours, np.float64), np.asarray(ref_bf16,
                                                              np.float64)
    ref_f32 = np.asarray(ref_f32, np.float64)
    reduce = np.sum if summed else np.max
    jax_distance = float(reduce(np.abs(ref_bf16 - ref_f32)))
    distance = float(reduce(np.abs(ours - ref_bf16)))
    assert jax_distance > 0, f"{what}: bfloat16 changed nothing in JAX"
    assert not np.array_equal(ours, np.asarray(ours_f32, np.float64)), \
        f"{what}: bfloat16 changed nothing in the port"
    assert distance <= 2 * jax_distance, (what, distance, jax_distance)


def _nhwc(x):
    return x.float().permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(scope="module")
def setup():
    jcfg = _configure(jax_cfg_defaults(), "float32")
    jmodules = {name: jax_build_modules(jcfg, NC, dtype=jdt)
                for name, (jdt, _) in DTYPES.items()}
    params, stats = jax_init_params(jax.random.PRNGKey(0),
                                    jmodules["float32"], (H, W))
    params = jax.tree.map(np.array, params)
    stats = jax.tree.map(np.array, stats)
    port = {}
    for name, (_, tdt) in DTYPES.items():
        pcfg = _configure(get_cfg_defaults(), name)
        port[name] = from_jax.load_from_jax(
            build_modules(pcfg, NC, device="cpu"), params, stats, pcfg)
        assert port[name].depth_head.compute_dtype == tdt
    rng = np.random.default_rng(0)
    image = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    pair = rng.normal(0, 1, (B, H, W, 6)).astype(np.float32)
    return {"jax": jmodules, "port": port, "params": params,
            "stats": stats, "image": image, "pair": pair, "rng": rng}


def _jax_forward(modules, params, stats, image, pair):
    feats, _ = jax_apply_encoder(modules.backbone_po_depth,
                                 params["backbone_po_depth"],
                                 stats["backbone_po_depth"], image,
                                 train=False)
    pose_feats, _ = jax_apply_encoder(modules.backbone_pose_sflow,
                                      params["backbone_pose_sflow"],
                                      stats["backbone_pose_sflow"], pair,
                                      train=False)
    # the heads take the float32 encoder's features on both sides
    return feats, pose_feats


def test_modules_match_in_bfloat16(setup):
    params, stats = setup["params"], setup["stats"]
    image, pair = setup["image"], setup["pair"]
    out = {}
    f32_feats = None
    for name in ("float32", "bfloat16"):
        modules = setup["jax"][name]

        def run(params, stats, image, pair, feats32, pose32):
            feats, pose_feats = _jax_forward(modules, params, stats, image,
                                             pair)
            depth, _ = modules.depth_head.apply(
                {"params": params["depth_head"]}, feats32)
            sem = modules.semantic_head.apply(
                {"params": params["semantic_head"]}, feats32)
            center, offset, mask = modules.instance_head.apply(
                {"params": params["instance_head"],
                 "batch_stats": stats["instance_head"]}, feats32,
                train=False)
            pose = modules.pose_head.apply({"params": params["pose_head"]},
                                           pose32)
            return {"feats": [f.astype(jnp.float32) for f in feats],
                    "pose_feats": pose_feats[-1].astype(jnp.float32),
                    "depth": depth, "semantic": sem, "center": center,
                    "offset": offset, "thing_mask": mask, "pose": pose}

        if f32_feats is None:
            f32_feats = jax.jit(lambda *args: _jax_forward(
                setup["jax"]["float32"], *args))(params, stats, image, pair)
        out[name] = jax.tree.map(np.asarray, jax.jit(run)(
            params, stats, image, pair, *f32_feats))

    feats32 = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2)
               .contiguous() for f in f32_feats[0]]
    pose32 = [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2)
              .contiguous() for f in f32_feats[1]]
    ours = {}
    with torch.no_grad():
        for name, modules in setup["port"].items():
            feats = modules.backbone_po_depth(
                torch.from_numpy(image).permute(0, 3, 1, 2).contiguous())
            pose_feats = modules.backbone_pose_sflow(
                torch.from_numpy(pair).permute(0, 3, 1, 2).contiguous())
            assert feats[-1].dtype == DTYPES[name][1]
            center, offset, mask = modules.instance_head(feats32)
            ours[name] = {
                "feats": [_nhwc(f) for f in feats],
                "pose_feats": _nhwc(pose_feats[-1]),
                "depth": _nhwc(modules.depth_head(feats32)[0]),
                "semantic": _nhwc(modules.semantic_head(feats32)),
                "center": _nhwc(center), "offset": _nhwc(offset),
                "thing_mask": _nhwc(mask),
                "pose": modules.pose_head(pose32).numpy()}
            for key in ("depth", "semantic", "center", "pose"):
                value = ours[name][key]
                assert value.dtype == np.float32, key
    for key, ref in out["bfloat16"].items():
        if key == "feats":
            for level, level_ref in enumerate(ref):
                _check(ours["bfloat16"][key][level], level_ref,
                       out["float32"][key][level],
                       ours["float32"][key][level], f"encoder level {level}")
        else:
            _check(ours["bfloat16"][key], ref, out["float32"][key],
                   ours["float32"][key], key)


def _images_and_geometry(rng):
    images = [rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
              for _ in range(3)]
    depth = rng.uniform(2.0, 30.0, (B, H, W, 1)).astype(np.float32)
    camera = np.tile(np.asarray([[50.0, 50.0, W / 2, H / 2]], np.float32),
                     (B, 1))
    poses = []
    for sign in (-1.0, 1.0):
        pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        pose[:, 0, 3] = 0.05 * sign
        pose[:, 2, 3] = 0.3 * sign
        poses.append(pose)
    return images, depth, camera, poses


def _jax_noise(key):
    out = []
    for s in range(NUM_SCALES):
        key, sub = jax.random.split(key)
        draw = jax.random.normal(sub, (B, H >> s, W >> s, 2), jnp.float32)
        out.append(torch.from_numpy(np.asarray(draw).transpose(0, 3, 1, 2)
                                    .copy()))
    return out


def test_losses_match_in_bfloat16(setup):
    rng = np.random.default_rng(1)
    images, depth, camera, poses = _images_and_geometry(rng)
    key = jax.random.PRNGKey(3)
    ref = {name: float(jax.jit(
        lambda imgs, d, cam, ps, jdt=jdt: jax_reconstruction_loss(
            key, cam, imgs, d, ps, num_scales=NUM_SCALES, dtype=jdt))(
        images, depth, camera, poses))
        for name, (jdt, _) in DTYPES.items()}

    def nchw(x):
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()

    ours = {}
    for name, (_, tdt) in DTYPES.items():
        noise = _jax_noise(key)
        ours[name] = float(reconstruction_loss(
            torch.from_numpy(camera), [nchw(i) for i in images],
            nchw(depth), [torch.from_numpy(p) for p in poses],
            num_scales=NUM_SCALES, noise=lambda shape: noise.pop(0),
            dtype=tdt))
    _check(ours["bfloat16"], ref["bfloat16"], ref["float32"],
           ours["float32"], "reconstruction_loss")

    logits = rng.normal(0, 2, (B, H, W, NC)).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, axis=-1))
    target = rng.integers(0, NC, (B, H, W)).astype(np.int32)
    target[:, :4] = 255
    weights = rng.uniform(0.5, 2.0, (B, H, W)).astype(np.float32)
    class_weights = list(rng.uniform(0.5, 1.5, NC))
    ref = {name: float(jax_semantic_loss(
        probs, target, weights, class_weights=class_weights,
        ignore_labels=[3], top_k_percent_pixels=0.2, dtype=jdt))
        for name, (jdt, _) in DTYPES.items()}
    ours = {name: float(semantic_loss(
        torch.from_numpy(probs).permute(0, 3, 1, 2),
        torch.from_numpy(target), torch.from_numpy(weights),
        class_weights=class_weights, ignore_labels=[3],
        top_k_percent_pixels=0.2, dtype=tdt))
        for name, (_, tdt) in DTYPES.items()}
    _check(ours["bfloat16"], ref["bfloat16"], ref["float32"],
           ours["float32"], "semantic_loss")


def _train_batch(rng):
    return {
        "frames": rng.integers(0, 256, (B, 3, H, W, 3), dtype=np.uint8),
        "camera": np.tile(np.asarray([[40.0, 40.0, W / 2, H / 2]],
                                     np.float32), (B, 1)),
        "semantic": rng.integers(0, NC, (B, H, W)).astype(np.int32),
        "semantic_weights": rng.uniform(0.5, 2.0, (B, H, W)).astype(
            np.float32),
        "center": rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32),
        "offset": rng.normal(0, 4, (B, H, W, 2)).astype(np.float32),
        "thing_mask": rng.integers(0, 2, (B, H, W)).astype(np.int32),
    }


def test_pretraining_loss_matches_in_bfloat16(setup):
    """The pretraining loss in train mode (batch statistics), no
    gradient, with the automask noise JAX draws, on LOSS_BATCHES batches.
    A scalar is one draw of each side's rounding, so the rule holds the
    distances summed over the batches: one batch's port and JAX errors,
    each about JAX's own distance, may fall on opposite sides."""
    rng = np.random.default_rng(2)
    batches = [_train_batch(rng) for _ in range(LOSS_BATCHES)]
    keys = [jax.random.PRNGKey(5 + i) for i in range(LOSS_BATCHES)]
    params, stats = setup["params"], setup["stats"]
    ref = {}
    for name in DTYPES:
        jcfg = _configure(jax_cfg_defaults(), name)
        loss_fn = jax.jit(jax_make_loss_fn(setup["jax"][name], jcfg,
                                           [1.0] * NC))
        ref[name] = []
        for key, batch in zip(keys, batches):
            total, (losses, _, _) = loss_fn(
                params, stats, key, jax.tree.map(jnp.asarray, batch))
            ref[name].append({"loss_total": float(total),
                              **{k: float(v) for k, v in losses.items()}})
    ours = {}
    for name, modules in setup["port"].items():
        pcfg = _configure(get_cfg_defaults(), name)
        loss_fn = make_loss_fn(pcfg, [1.0] * NC)
        saved = {k: v.clone() for k, v in modules.state_dict().items()}
        ours[name] = []
        for key, batch in zip(keys, batches):
            _, sub = jax.random.split(key)
            noise = _jax_noise(sub)
            with torch.no_grad():
                total, losses, _ = loss_fn(
                    modules, {k: torch.from_numpy(v)
                              for k, v in batch.items()},
                    lambda shape: noise.pop(0))
            # train mode moved the running statistics
            modules.load_state_dict(saved)
            ours[name].append({"loss_total": float(total),
                               **{k: float(v) for k, v in losses.items()}})
        modules.eval()
    assert set(ours["bfloat16"][0]) == set(ref["bfloat16"][0])
    for key_name in ref["bfloat16"][0]:
        def series(runs):
            return [run[key_name] for run in runs]
        _check(series(ours["bfloat16"]), series(ref["bfloat16"]),
               series(ref["float32"]), series(ours["float32"]), key_name,
               summed=True)
