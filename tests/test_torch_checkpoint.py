"""Checkpoints between the port and ``codeps_tpu``.

A ``.pth`` that the port's ``save_checkpoint`` writes from bridged JAX
weights loads bit for bit into the JAX package
(``codeps_tpu.io.pretrained_from_checkpoints``); a ``.pkl`` that the JAX
package's ``save_checkpoint`` writes loads into the port bit for bit as
the weight bridge gives it; ``module:path`` loads that module only; a key
the checkpoint lacks keeps its value, a key the module lacks is ignored,
a shape mismatch raises; an Orbax directory raises. ResNet-18 modules.
"""

import json

import numpy as np
import pytest
import torch

import jax

from codeps_tpu.config import gen_config as jax_gen_config
from codeps_tpu.io import pretrained_from_checkpoints as jax_pretrained
from codeps_tpu.io import save_checkpoint as jax_save_checkpoint
from codeps_tpu.models import build_modules as jax_build_modules
from codeps_tpu.models import init_params as jax_init_params

from codeps_torch.config import gen_config
from codeps_torch.io import from_jax
from codeps_torch.io.checkpoint import (load_checkpoint, make_modules_list,
                                        pretrained_from_checkpoints,
                                        save_checkpoint)
from codeps_torch.models import build_modules, init_params

NC = 14


def _configure(cfg):
    cfg.model.po_depth_net.params.nof_layers = 18
    cfg.dataset.feed_img_size = [32, 64]
    cfg.tpu.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, params, batch stats) of seeded JAX modules."""
    jcfg = _configure(jax_gen_config(adapt=True, freeze=False))
    pcfg = _configure(gen_config(adapt=True, freeze=False))
    modules = jax_build_modules(jcfg, NC)
    params, stats = jax_init_params(jax.random.PRNGKey(0), modules, (32, 64))
    return (jcfg, pcfg, jax.tree.map(np.array, params),
            jax.tree.map(np.array, stats))


def _fresh(cfg, seed=1):
    return init_params(build_modules(cfg, NC, device="cpu"), seed=seed,
                       device="cpu")


def _state_dicts(modules):
    return {name: {k: v.clone() for k, v in
                   getattr(modules, name).state_dict().items()}
            for name in modules.module_names()}


def _assert_trees_equal(ours, ref, path=()):
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for key in ref:
            _assert_trees_equal(ours[key], ref[key], path + (key,))
    else:
        ours, ref = np.asarray(ours), np.asarray(ref)
        assert ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=str(path))


def test_port_pth_loads_bit_exact_into_jax(weights, tmp_path):
    jcfg, pcfg, params, stats = weights
    modules = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                     params, stats, pcfg)
    path = tmp_path / "port.pth"
    save_checkpoint(str(path), pcfg, modules, epoch=3, global_step=17)
    zeros = jax.tree.map(np.zeros_like, (params, stats))
    loaded_params, loaded_stats = jax_pretrained([str(path)], *zeros, jcfg)
    _assert_trees_equal(jax.tree.map(np.asarray, loaded_params), params)
    _assert_trees_equal(jax.tree.map(np.asarray, loaded_stats), stats)

    ckpt = load_checkpoint(str(path))
    assert ckpt["training_meta"] == {"epoch": 3, "global_step": 17}
    config = json.loads(ckpt["config"])
    assert config["dataset"]["feed_img_size"] == [32, 64]
    assert sorted(ckpt["state_dict"]) == sorted(make_modules_list(pcfg))


def test_jax_pkl_loads_into_port_as_the_bridge_gives_it(weights, tmp_path):
    jcfg, pcfg, params, stats = weights
    path = tmp_path / "jax.pkl"
    jax_save_checkpoint(str(path), jcfg, 0, 0, params, stats)
    ours = _fresh(pcfg)
    loaded = pretrained_from_checkpoints([str(path)], ours, pcfg)
    assert loaded == ours.module_names()
    ref = from_jax.load_from_jax(build_modules(pcfg, NC, device="cpu"),
                                 params, stats, pcfg)
    for name, sd in _state_dicts(ref).items():
        got = getattr(ours, name).state_dict()
        for key, value in sd.items():
            assert torch.equal(got[key], value), (name, key)


def test_module_spec_loads_only_that_module(weights, tmp_path):
    _, pcfg, _, _ = weights
    source = _fresh(pcfg, seed=5)
    path = tmp_path / "source.pth"
    save_checkpoint(str(path), pcfg, source)
    target = _fresh(pcfg, seed=6)
    before = _state_dicts(target)
    loaded = pretrained_from_checkpoints([f"depth_head:{path}"], target,
                                         pcfg)
    assert loaded == ["depth_head"]
    after = _state_dicts(target)
    for key, value in source.depth_head.state_dict().items():
        assert torch.equal(after["depth_head"][key], value), key
    for name in target.module_names():
        if name != "depth_head":
            for key, value in before[name].items():
                assert torch.equal(after[name][key], value), (name, key)


def test_non_strict_and_shape_checked(weights, tmp_path):
    _, pcfg, _, _ = weights
    source = _fresh(pcfg, seed=5)
    sd = {name: dict(getattr(source, name).state_dict())
          for name in source.module_names()}
    dropped = sorted(sd["semantic_head"])[::2]
    for key in dropped:
        del sd["semantic_head"][key]
    # the reference depth head's coarser disparity convs, unused here
    for scale in (1, 2, 3):
        sd["depth_head"][f"dispconvs.{scale}.weight"] = torch.ones(1, 8, 3, 3)
    path = tmp_path / "partial.pth"
    torch.save({"state_dict": sd}, path)
    target = _fresh(pcfg, seed=6)
    before = _state_dicts(target)
    pretrained_from_checkpoints([str(path)], target, pcfg)
    for key, value in target.semantic_head.state_dict().items():
        expect = before["semantic_head"][key] if key in dropped \
            else sd["semantic_head"][key]
        assert torch.equal(value, expect), key
    for key, value in target.depth_head.state_dict().items():
        assert torch.equal(value, sd["depth_head"][key]), key

    key = next(iter(sd["pose_head"]))
    sd["pose_head"][key] = torch.zeros(3, 3)
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match="Shape mismatch in module "
                                         "pose_head"):
        pretrained_from_checkpoints([str(path)], target, pcfg)


def test_orbax_directory_raises(weights, tmp_path):
    jcfg, pcfg, params, stats = weights
    path = tmp_path / "orbax_ckpt"
    small = {"depth_head": params["depth_head"]}
    jax_save_checkpoint(str(path), jcfg, 0, 0, small, {})
    assert path.is_dir()
    with pytest.raises(ValueError, match="Orbax"):
        pretrained_from_checkpoints([str(path)], _fresh(pcfg), pcfg)
