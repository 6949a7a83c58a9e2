"""Run configuration: the JAX package's config trees, copied so the port
imports nothing of it. YAML is read only inside the functions that open a
file, so importing this package needs no ``yaml``."""

from benchmark.reference.codeps_ref.config.node import ConfigNode
from benchmark.reference.codeps_ref.config.defaults import get_cfg_defaults, get_cfg_defaults_adapt


__all__ = ["ConfigNode", "get_cfg_defaults", "get_cfg_defaults_adapt",
           "gen_config", "load_config"]
