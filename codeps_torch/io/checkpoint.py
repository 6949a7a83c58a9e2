"""Checkpoints at the reference's module granularity.

Counterpart of ``codeps_tpu/io/checkpoint.py``:

  - ``save_checkpoint`` writes the reference's ``.pth`` layout
    (``io_utils.py:76-88``): the config text, one ``state_dict`` per
    module and ``training_meta``; it is also the port's own layout, so a
    reference checkpoint loads as it is;
  - ``load_checkpoint`` reads such a ``.pth`` (any ``torch.save`` file)
    or a pickle written by the JAX package's ``save_checkpoint(...
    ".pkl")``, whose numpy trees go through the weight bridge
    (``io/from_jax.state_dicts_from_jax``); an Orbax directory raises,
    saying how to convert it;
  - ``resume_from_checkpoint`` loads per module, non-strict and
    shape-checked: a key the checkpoint lacks keeps its current value, a
    key the module lacks is ignored (the reference depth head's unused
    ``dispconvs.{1,2,3}``, for one), a shape mismatch raises;
  - ``pretrained_from_checkpoints`` takes the CLI's ``module:path`` specs.

Optimizer, RNG and meter state (``codeps_tpu/io/checkpoint.py:143-187``)
come with the pretraining slice. Checkpoints are unpickled in full (they
hold the config and, from the reference, more than tensors): load only
trusted files.
"""

from __future__ import annotations

import json
import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def make_modules_list(cfg) -> List[str]:
    """Module names implied by the model flags (``io_utils.py:18-33``)."""
    modules = ["backbone_po_depth"]
    if cfg.model.make_depth:
        modules += ["backbone_pose_sflow", "depth_head", "pose_head"]
        if cfg.model.make_sflow:
            modules += ["flow_head"]
    if cfg.model.make_semantic:
        modules += ["semantic_head"]
    if cfg.model.make_instance:
        modules += ["instance_head"]
    return modules


def save_checkpoint(path: str, cfg, modules, epoch: int = 0,
                    global_step: int = 0) -> None:
    """Write ``modules`` (a ``CodepsModules``) as a reference-layout
    ``.pth``: ``{"config": text, "state_dict": {module: state_dict},
    "training_meta": {"epoch", "global_step"}}``, tensors on the CPU. The
    config text is JSON, which YAML readers also read (the card machine
    has no YAML writer)."""
    payload = {
        "config": json.dumps(cfg.to_dict(), indent=1, default=str),
        "state_dict": {
            name: {key: value.detach().cpu() for key, value in
                   getattr(modules, name).state_dict().items()}
            for name in modules.module_names()},
        "training_meta": {"epoch": epoch, "global_step": global_step},
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict at ``path``: a ``torch.save`` file (the
    reference's ``.pth``) or a pickle of the JAX package."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint of the JAX "
            "package; the port reads no Orbax. Convert it where JAX and "
            "Orbax are installed: restore it with "
            "codeps_tpu.io.load_checkpoint and write it again with "
            "codeps_tpu.io.save_checkpoint to a path ending in '.pkl' "
            "(numpy trees), which this function reads")
    if path.suffix == ".pth" or zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=False)
    with open(path, "rb") as handle:
        return pickle.load(handle)


def checkpoint_state_dicts(checkpoint: Dict[str, Any], cfg) -> StateDicts:
    """{module: state_dict} of a loaded checkpoint: the reference layout
    as it is, the JAX package's ``params``/``batch_stats`` trees through
    the weight bridge."""
    state = checkpoint["state_dict"]
    if "params" not in state:
        return state
    from codeps_torch.io.from_jax import state_dicts_from_jax
    return state_dicts_from_jax(state["params"],
                                state.get("batch_stats", {}), cfg)


def _check_and_merge(target: Dict[str, torch.Tensor],
                     loaded: Dict[str, torch.Tensor], module: str
                     ) -> Dict[str, torch.Tensor]:
    """``target`` with every key that ``loaded`` also holds taken from it;
    shapes must match (``io_utils.py:91-115``)."""
    merged = dict(target)
    for key, value in target.items():
        if key not in loaded:
            continue
        new = loaded[key]
        if tuple(new.shape) != tuple(value.shape):
            raise ValueError(
                f"Shape mismatch in module {module} at {key}: "
                f"{tuple(new.shape)} vs {tuple(value.shape)}")
        merged[key] = new
    return merged


def resume_from_checkpoint(state_dicts: StateDicts, modules,
                           module_names: Optional[Sequence[str]] = None
                           ) -> List[str]:
    """Load each module of ``modules`` that ``state_dicts`` holds (only
    those in ``module_names`` when given), non-strict and shape-checked;
    returns the names loaded."""
    loaded = []
    for name in modules.module_names():
        if module_names is not None and name not in module_names:
            continue
        if name not in state_dicts:
            continue
        module = getattr(modules, name)
        module.load_state_dict(_check_and_merge(
            module.state_dict(), state_dicts[name], name))
        loaded.append(name)
    return loaded


def pretrained_from_checkpoints(checkpoint_specs: Sequence[str], modules,
                                cfg) -> List[str]:
    """Load pretrained weights into ``modules`` from ``path`` or
    ``module:path`` specs (``io_utils.py:52-73``): a bare path loads every
    module it holds, ``module:path`` that module only. Returns the names
    loaded, in order."""
    loaded: List[str] = []
    for spec in checkpoint_specs:
        module, path = None, spec
        if ":" in spec and not Path(spec).exists():
            module, path = spec.split(":", 1)
        state_dicts = checkpoint_state_dicts(load_checkpoint(path), cfg)
        loaded += resume_from_checkpoint(
            state_dicts, modules, [module] if module else None)
    return loaded
