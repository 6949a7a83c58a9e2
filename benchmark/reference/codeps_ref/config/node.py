"""Lightweight hierarchical configuration node.

Provides a yacs-compatible surface (attribute access, ``merge_from_file``,
``clone``, ``freeze``) without the yacs dependency, so the public YAML
configs of CoDEPS (``cfg/train_cityscapes.yaml``, ``cfg/adapt_*.yaml``)
keep working unchanged. ``yaml`` is imported only by the methods that
read or write YAML.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class ConfigNode:
    """A dict-backed node with attribute access and optional immutability."""

    def __init__(self, init: Dict[str, Any] | None = None):
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_data", {})
        if init:
            for key, value in init.items():
                self[key] = value

    # -- mapping protocol ------------------------------------------------

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if self._frozen:
            raise AttributeError(f"ConfigNode is frozen; cannot set {key!r}")
        if isinstance(value, dict):
            value = ConfigNode(value)
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- attribute access ------------------------------------------------

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            # Internal slots live in __dict__ only. During unpickling the
            # instance exists before __init__/__setstate__ populates them;
            # falling through to self._data here would self-recurse.
            raise AttributeError(key)
        try:
            return self._data[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    # -- pickling ----------------------------------------------------------
    # Nodes travel inside pickled dataset objects (the replay buffer's
    # saved state carries the previous domain's dataset across
    # continual-chain runs).

    def __getstate__(self):
        return {"_frozen": self._frozen, "_data": self._data}

    def __setstate__(self, state):
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_data", state["_data"])
        object.__setattr__(self, "_frozen", state["_frozen"])

    # -- yacs-compatible operations ---------------------------------------

    def clone(self) -> "ConfigNode":
        node = ConfigNode()
        for key, value in self._data.items():
            if isinstance(value, ConfigNode):
                node[key] = value.clone()
            else:
                node[key] = copy.deepcopy(value)
        return node

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for value in self._data.values():
            if isinstance(value, ConfigNode):
                value.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", False)
        for value in self._data.values():
            if isinstance(value, ConfigNode):
                value.defrost()
        return self

    def is_frozen(self) -> bool:
        return self._frozen

    def merge_from_dict(self, other: Dict[str, Any],
                        strict: bool = False,
                        _path: str = "") -> "ConfigNode":
        """Recursively merge ``other`` into this node.

        ``strict=True`` raises KeyError on keys absent from this tree
        (yacs ``merge_from_file`` semantics — a typo'd override must
        fail loudly, not silently train with the default); the default
        permissive mode is for building the trees themselves.
        """
        if self._frozen:
            raise AttributeError("ConfigNode is frozen; cannot merge")
        for key, value in other.items():
            full = f"{_path}.{key}" if _path else key
            if strict and key not in self._data:
                raise KeyError(f"Non-existent config key: {full}")
            if (
                key in self._data
                and isinstance(self._data[key], ConfigNode)
                and isinstance(value, (dict, ConfigNode))
            ):
                sub = value.to_dict() if isinstance(value, ConfigNode) else value
                self._data[key].merge_from_dict(sub, strict=strict,
                                                _path=full)
            else:
                self[key] = copy.deepcopy(
                    value.to_dict() if isinstance(value, ConfigNode) else value)
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        """Strict merge of a user YAML (yacs parity: unknown keys raise)."""
        import yaml
        with open(path, "r", encoding="utf-8") as handle:
            overrides = yaml.safe_load(handle) or {}
        return self.merge_from_dict(overrides, strict=True)

    def merge_from_list(self, opts: list) -> "ConfigNode":
        """Merge from a flat ``["a.b.c", value, ...]`` list (CLI overrides).

        String values are literal-evaluated like yacs (argv delivers
        strings; storing '0.001' verbatim would poison typed leaves),
        falling back to the raw string for plain words.
        """
        import ast
        assert len(opts) % 2 == 0, "Override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for part in parts[:-1]:
                node = node[part]
            if parts[-1] not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass  # plain strings (names, paths) stay strings
            node[parts[-1]] = value
        return self

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for key, value in self._data.items():
            out[key] = value.to_dict() if isinstance(value, ConfigNode) else value
        return out

    def dump(self) -> str:
        """YAML serialization of the full tree (checkpoint snapshots)."""
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict() == other.to_dict()
        return NotImplemented
