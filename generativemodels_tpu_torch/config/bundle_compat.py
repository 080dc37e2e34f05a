"""Load *reference* MONAI-bundle configs against the port.

Counterpart of generativemodels_tpu/config/bundle_compat.py: the model-zoo
bundles name `generative.*` torch classes in their `_target_` strings;
this rewrites the prefixes to the port's modules so an unmodified bundle
file instantiates the port's networks, schedulers and inferers. Entries
that are the bundle's runtime plumbing stay in the tree un-instantiated:
request only the ids you need.

Example::

    from generativemodels_tpu_torch.config import load_reference_bundle
    parser = load_reference_bundle("bundle/configs/common.json")
    unet = parser.resolve("network_def")
"""
from __future__ import annotations

from typing import Any

from .parser import ConfigParser

PORT = "generativemodels_tpu_torch"

# Prefix rewrites, most specific first.
TARGET_PREFIX_MAP: tuple[tuple[str, str], ...] = (
    ("generative.networks.nets.", f"{PORT}.networks.nets."),
    ("generative.networks.schedulers.", f"{PORT}.networks.schedulers."),
    ("generative.networks.blocks.", f"{PORT}.networks.blocks."),
    ("generative.networks.layers.", f"{PORT}.networks.layers."),
    ("generative.inferers.", f"{PORT}.inferers."),
    ("generative.losses.", f"{PORT}.losses."),
    ("generative.metrics.", f"{PORT}.metrics."),
    ("generative.engines.", f"{PORT}.engines."),
    ("generative.utils.", f"{PORT}.utils."),
)


def rewrite_targets(node: Any, extra_map: dict[str, str] | None = None) -> Any:
    """Recursively rewrite `_target_` strings from reference to port names.

    `extra_map` maps *exact* target strings (e.g. a bundle's local
    ``scripts.sampler.Sampler``) to replacement dotted paths. The bundles'
    `_requires_` chains (state-dict loads, device moves) are dropped.
    """
    if isinstance(node, dict):
        out = {}
        for key, value in node.items():
            if key == "_requires_":
                continue
            if key == "_target_" and isinstance(value, str):
                value = _rewrite_one(value, extra_map)
            else:
                value = rewrite_targets(value, extra_map)
            out[key] = value
        return out
    if isinstance(node, list):
        return [rewrite_targets(item, extra_map) for item in node]
    return node


def _rewrite_one(target: str, extra_map: dict[str, str] | None) -> str:
    if extra_map and target in extra_map:
        return extra_map[target]
    for prefix, replacement in TARGET_PREFIX_MAP:
        if target.startswith(prefix):
            return replacement + target[len(prefix):]
    return target


def load_reference_bundle(
    path: str, extra_map: dict[str, str] | None = None
) -> ConfigParser:
    """Parse a reference bundle JSON/YAML file with targets rewritten.

    Returns a :class:`ConfigParser`; call ``resolve(id)`` for the ids you
    need (``network_def``, ``scheduler``, ``inferer``, ...).
    """
    parser = ConfigParser.load_file(path)
    return ConfigParser(rewrite_targets(parser.config, extra_map))
