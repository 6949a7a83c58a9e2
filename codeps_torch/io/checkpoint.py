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
  - ``pretrained_from_checkpoints`` takes the CLI's ``module:path`` specs;
  - ``restore_opt_state``, ``restore_rng`` and ``restore_meters``
    (``codeps_tpu/io/checkpoint.py:143-187``) resume a training run from
    the optimizer, generator and meter state that ``save_checkpoint``
    writes beside the modules. The optimizer state of a JAX ``.pkl`` (the
    flat optax leaf list) goes through the weight bridge
    (``io/from_jax.adam_state_from_jax``). A JAX PRNG key cannot seed a
    ``torch.Generator`` to the same draws: ``restore_rng`` returns a
    generator state only from the port's own checkpoints.

Checkpoints are unpickled in full (they hold the config and, from the
reference, more than tensors): load only trusted files.
"""

from __future__ import annotations

import json
import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch

from codeps_torch import parallel

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


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def save_checkpoint(path: str, cfg, modules, epoch: int = 0,
                    global_step: int = 0,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None,
                    meters: Optional[Dict[str, Any]] = None) -> None:
    """Write ``modules`` (a ``CodepsModules``) as a reference-layout
    ``.pth``: ``{"config": text, "state_dict": {module: state_dict},
    "training_meta": {"epoch", "global_step"}}``, tensors on the CPU. The
    config text is JSON, which YAML readers also read (the card machine
    has no YAML writer). ``state_dict`` also takes, when given, the
    optimizer's state dict (``"optimizer"``), the generator's state
    (``"rng"``) and the meters' state dicts (``"meters"``), where the JAX
    package keeps them. Inside a process group (``parallel/dist.py``)
    rank 0 writes and every rank waits until it has."""
    payload = {
        "config": json.dumps(cfg.to_dict(), indent=1, default=str),
        "state_dict": {
            name: {key: value.detach().cpu() for key, value in
                   getattr(modules, name).state_dict().items()}
            for name in modules.module_names()},
        "training_meta": {"epoch": epoch, "global_step": global_step},
    }
    if optimizer is not None:
        payload["state_dict"]["optimizer"] = _to_cpu(
            optimizer.state_dict())
    if generator is not None:
        payload["state_dict"]["rng"] = generator.get_state()
    if meters is not None:
        payload["state_dict"]["meters"] = {
            name: meter.state_dict() for name, meter in meters.items()}
    if parallel.is_lead():
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, path)
    parallel.barrier()


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


def restore_opt_state(checkpoint: Dict[str, Any], optimizer, modules, cfg,
                      frozen_modules: Sequence[str] = ()) -> bool:
    """Load the optimizer state of ``checkpoint`` into ``optimizer`` (Adam
    over the parameters of the modules of ``modules`` not in
    ``frozen_modules``, in module order); False when it holds none.

    The port's own checkpoints hold torch's optimizer state dict. A JAX
    ``.pkl`` holds optax's flat leaf list: its Adam moments map to
    ``exp_avg``/``exp_avg_sq`` through the weight bridge and its count to
    ``step``. Either must have been written for the same live modules.
    """
    saved = checkpoint["state_dict"].get("optimizer")
    if saved is None:
        return False
    if isinstance(saved, dict) and "param_groups" in saved:
        optimizer.load_state_dict(saved)
        return True
    from codeps_torch.io.from_jax import adam_state_from_jax
    live = [name for name in modules.module_names()
            if name not in frozen_modules]
    state = adam_state_from_jax(saved, checkpoint["state_dict"]["params"],
                                checkpoint["state_dict"].get(
                                    "batch_stats", {}),
                                live, cfg)
    params = [p for name in live
              for p in getattr(modules, name).parameters()]
    if len(params) != sum(len(g["params"]) for g in optimizer.param_groups):
        raise ValueError("the optimizer does not hold the live modules' "
                         "parameters")
    for name in live:
        for key, param in getattr(modules, name).named_parameters():
            moments = state[name][key]
            optimizer.state[param] = {
                "step": torch.tensor(float(moments["step"])),
                "exp_avg": moments["exp_avg"].to(param.device),
                "exp_avg_sq": moments["exp_avg_sq"].to(param.device)}
    return True


def restore_rng(checkpoint: Dict[str, Any]) -> Optional[torch.Tensor]:
    """The generator state a port checkpoint saved (for
    ``torch.Generator.set_state``), or None: no state was saved, or the
    checkpoint is the JAX package's, whose PRNG key no torch generator can
    continue."""
    rng = checkpoint["state_dict"].get("rng")
    if isinstance(rng, torch.Tensor) and rng.dtype == torch.uint8:
        return rng
    return None


def restore_meters(checkpoint: Dict[str, Any],
                   meters: Dict[str, Any]) -> Dict[str, Any]:
    """Load the meter states ``save_checkpoint`` wrote into the live
    ``meters`` that share their names."""
    import numpy as np
    saved = checkpoint["state_dict"].get("meters") or {}
    for name, meter in meters.items():
        if name in saved:
            meter.load_state_dict({key: np.asarray(value)
                                   for key, value in saved[name].items()})
    return meters
