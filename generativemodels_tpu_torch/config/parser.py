"""Declarative config instantiation (MONAI-bundle-style).

Counterpart of generativemodels_tpu/config/parser.py, the same semantics
over plain dicts:
  {"_target_": "pkg.mod.Class", "kw": ...}  -> Class(kw=...)
  "@a::b" or "@a#b"                         -> resolved item at config[a][b]
  "$<python expr>"                          -> eval'd, with @refs substituted
  "_disabled_": truthy                      -> instantiation returns None
JSON files need nothing beyond the standard library; a `.yaml` file needs
PyYAML, imported only for it, and raises an ImportError that says so where
it is missing (the package's own presets are JSON).
"""
from __future__ import annotations

import importlib
import json
import math
import re
from typing import Any

_REF = re.compile(r"@([\w]+(?:(?:::|#)[\w]+)*)")


def _import_target(path: str):
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ must be a dotted path, got {path!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def _split_id(item_id: str) -> list[str]:
    return re.split(r"::|#", item_id)


class ConfigParser:
    """Parses and lazily instantiates a bundle-style config tree.

    Example::

        parser = ConfigParser({
            "channels": [8, 8],
            "network": {
                "_target_": "generativemodels_tpu_torch.networks.nets.DiffusionModelUNet",
                "spatial_dims": 2, "in_channels": 1, "out_channels": 1,
                "num_channels": "@channels",
                "attention_levels": "$[False] * len(@channels)",
            },
        })
        net = parser.resolve("network")
    """

    def __init__(self, config: dict | None = None) -> None:
        self.config: dict = config or {}
        self._cache: dict[str, Any] = {}

    # -- loading -------------------------------------------------------------

    @classmethod
    def load_file(cls, path: str) -> "ConfigParser":
        """Load a JSON or YAML config file."""
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError as exc:
                raise ImportError(
                    f"{path} is YAML and PyYAML is not installed; convert it to JSON "
                    "(the package's presets are JSON) or install PyYAML"
                ) from exc
            with open(path) as f:
                return cls(yaml.safe_load(f))
        with open(path) as f:
            return cls(json.load(f))

    def update(self, overrides: dict) -> None:
        """Shallow-merge overrides (mix-in configs like train_multigpu.yaml)."""
        self.config.update(overrides)
        self._cache.clear()

    # -- resolution ----------------------------------------------------------

    def _get_raw(self, item_id: str):
        node = self.config
        for part in _split_id(item_id):
            if isinstance(node, (list, tuple)):
                node = node[int(part)]
            else:
                node = node[part]
        return node

    def resolve(self, item_id: str):
        """Resolve (and instantiate) the item at `item_id`."""
        if item_id in self._cache:
            return self._cache[item_id]
        value = self._evaluate(self._get_raw(item_id))
        self._cache[item_id] = value
        return value

    def _evaluate(self, node):
        if isinstance(node, dict):
            if "_target_" in node:
                if node.get("_disabled_"):
                    return None
                # bundle `_requires_`: evaluated first (for side effects /
                # forced resolution order), never passed as a kwarg
                if "_requires_" in node:
                    self._evaluate(node["_requires_"])
                kwargs = {
                    k: self._evaluate(v)
                    for k, v in node.items()
                    if k not in ("_target_", "_disabled_", "_requires_")
                }
                return _import_target(node["_target_"])(**kwargs)
            return {k: self._evaluate(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self._evaluate(v) for v in node]
        if isinstance(node, str):
            if node.startswith("$"):
                return self._eval_expr(node[1:])
            if node.startswith("@"):
                return self.resolve(node[1:])
        return node

    def _eval_expr(self, expr: str):
        """Evaluate a $-expression; @refs become local variables."""
        local_vars = {}

        def _sub(match):
            ref = match.group(1)
            var = "_ref_" + ref.replace("::", "__").replace("#", "__")
            local_vars[var] = self.resolve(ref)
            return var

        substituted = _REF.sub(_sub, expr)
        safe_globals = {"__builtins__": {}, "math": math, "len": len, "int": int,
                        "float": float, "str": str, "list": list, "tuple": tuple,
                        "min": min, "max": max, "sum": sum, "range": range,
                        "True": True, "False": False, "None": None}
        return eval(substituted, safe_globals, local_vars)  # noqa: S307
