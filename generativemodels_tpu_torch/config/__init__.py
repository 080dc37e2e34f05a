"""Bundle-style configs: the parser, the reference-bundle loader and the presets.

Counterpart of generativemodels_tpu/config/. The presets are JSON copies
of the JAX package's YAML presets with their targets naming the port's
classes (tests hold each equal to the YAML after that rewrite).
"""
import os

from .bundle_compat import load_reference_bundle, rewrite_targets
from .parser import ConfigParser

PRESET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "presets")


def load_preset(name: str) -> ConfigParser:
    """Load a named preset config (e.g. "mednist_ddpm", "brain_3d_ldm")."""
    path = os.path.join(PRESET_DIR, f"{name}.json")
    if not os.path.exists(path):
        available = sorted(f[:-5] for f in os.listdir(PRESET_DIR) if f.endswith(".json"))
        raise FileNotFoundError(f"no preset {name!r}; available: {available}")
    return ConfigParser.load_file(path)


__all__ = [
    "ConfigParser",
    "load_preset",
    "load_reference_bundle",
    "rewrite_targets",
    "PRESET_DIR",
]
