"""Configurations, cells and traffic mixes, found by name.

``benchmark/configs/<config>.json``: ``values`` (dotted keys of the port's
config tree, set over the defaults that ``defaults`` names, ``adapt`` or
``train``), ``copied`` (pairs of dotted keys: the second takes the first's
value, as the adaptation CLI's ``gen_config`` copies dataset settings to
the source), ``num_classes``, ``source``, ``reduced`` and ``assumed``.
``benchmark/workloads/<cell>.json``: its ``config``, its ``traffic`` and the
``limits`` of the numbers that decide ``correct``.
``benchmark/traffic/<traffic>.json``: the ``driver`` (a module of
``benchmark/drivers``) and its parameters.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """The JSON file ``benchmark/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (ROOT / kind).glob("*.json"))
        raise KeyError(f"no {kind} file named {name!r} (have {known})")
    return json.loads(path.read_text())


def cell(name: str) -> dict:
    """The cell ``name`` with its configuration and traffic resolved:
    ``{"name", "config": {...}, "traffic": {...}, "limits": {...}}``."""
    entry = load("workloads", name)
    return {"name": name,
            "config": dict(load("configs", entry["config"]),
                           name=entry["config"]),
            "traffic": dict(load("traffic", entry["traffic"]),
                            name=entry["traffic"]),
            "limits": dict(entry.get("limits", {}))}


def _parent(cfg, dotted: str):
    *path, key = dotted.split(".")
    node = cfg
    for part in path:
        node = node[part]
    return node, key


def apply(cfg, config: dict):
    """``cfg`` (a config tree of the port or of the frozen copy) with the
    configuration's ``values`` and ``copied`` keys set; returns it."""
    for dotted, value in config["values"].items():
        node, key = _parent(cfg, dotted)
        node[key] = copy.deepcopy(value)
    for source, target in config.get("copied", []):
        node, key = _parent(cfg, source)
        value = node[key]
        node, key = _parent(cfg, target)
        node[key] = copy.deepcopy(value)
    return cfg
