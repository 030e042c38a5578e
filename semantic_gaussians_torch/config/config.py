"""Config system: YAML + CLI dotlist overrides.

Port of semantic_gaussians_tpu.config.config: load a YAML file, merge
`a.b.c=value` overrides (values YAML-parsed), look up nested keys with a
default, print the resolved config.
"""
from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, List, Optional

import yaml


class DotDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return DotDict({k: DotDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [DotDict.wrap(v) for v in obj]
        return obj

    def to_dict(self):
        def un(v):
            if isinstance(v, DotDict):
                return v.to_dict()
            if isinstance(v, list):
                return [un(x) for x in v]
            return v

        return {k: un(v) for k, v in self.items()}


def load_yaml(path) -> DotDict:
    with open(path) as f:
        return DotDict.wrap(yaml.safe_load(f) or {})


def merge_dotlist(cfg: DotDict, dotlist: List[str]) -> DotDict:
    """Apply `a.b=value` overrides (values parsed as YAML scalars)."""
    cfg = DotDict.wrap(copy.deepcopy(cfg.to_dict()))
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, raw = item.split("=", 1)
        val = yaml.safe_load(raw)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = DotDict()
            node = node[p]
        node[parts[-1]] = DotDict.wrap(val)
    return cfg


def load_config(path, argv: Optional[List[str]] = None) -> DotDict:
    """YAML + sys.argv-style dotlist merge (arguments without '=' or with a
    leading '-' are left to the caller)."""
    import sys

    cfg = load_yaml(path)
    dotlist = argv if argv is not None else sys.argv[2:]
    dotlist = [a for a in dotlist if "=" in a and not a.startswith("-")]
    return merge_dotlist(cfg, dotlist)


def resolve(cfg: DotDict, *keys, default=None) -> Any:
    """cfg[k0][k1]...; `default` where a key is missing or a node on the
    way is not a dict."""
    node = cfg
    for k in keys:
        if not isinstance(node, dict) or k not in node:
            return default
        node = node[k]
    return node


def pretty(cfg: DotDict) -> str:
    return yaml.safe_dump(cfg.to_dict(), sort_keys=False)


def default_config_dir() -> Path:
    return Path(__file__).parent / "yamls"
