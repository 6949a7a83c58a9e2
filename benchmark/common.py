"""Helpers shared by the drivers, the reference and the judge."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def to_host(tree):
    """A copy on the host of every tensor in ``tree`` (nested dicts,
    lists and tuples); numpy arrays are copied, other leaves kept."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def leaf_norms(named) -> dict:
    """{name: float L2 norm} of (name, tensor) pairs, in one readback."""
    named = list(named)
    if not named:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(t.detach().float())
                         for _, t in named]).cpu().tolist()
    return {name: value for (name, _), value in zip(named, norms)}


@torch.no_grad()
def change_norms(named, initial: dict) -> dict:
    """{name: |tensor - initial[name]|} for (name, tensor) pairs."""
    return leaf_norms((name, t.detach().float()
                       - initial[name].to(t.device).float())
                      for name, t in named)


def adam_gradient_norms(optimizer, names: dict) -> dict:
    """{name: |g|} of the gradient each parameter's Adam first moment took
    on the first step: exp_avg = (1 - beta1) g. ``names`` maps a
    parameter to its name."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    pairs = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "exp_avg" in state:
                pairs.append((names[p], state["exp_avg"] / (1.0 - beta1)))
    return leaf_norms(pairs)


def gpu_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (empty
    where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"smi_name": name.strip(), "power_limit": limit.strip()}
