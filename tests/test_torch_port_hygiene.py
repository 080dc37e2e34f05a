"""The port stands alone: it imports no JAX and calls no finished attention kernel."""
from __future__ import annotations

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import generativemodels_tpu_torch

PORT_DIR = Path(generativemodels_tpu_torch.__file__).parent
REPO = PORT_DIR.parent
FORBIDDEN = ("scaled_dot_product_attention", "torch.compile", "import jax", "from jax")


def _port_modules() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PORT_DIR)], prefix="generativemodels_tpu_torch.")
    )


def test_port_modules_import_without_jax():
    modules = _port_modules()
    for name in ("recipes.serve", "recipes.train_2d_ddpm", "parallel.train", "utils.profiling"):
        assert f"generativemodels_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "loaded = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not loaded, loaded\n"
        "assert not any(m.startswith('generativemodels_tpu.') for m in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_port_sources_avoid(pattern):
    sources = [p for p in PORT_DIR.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".h")]
    sources.append(REPO / "chip_smoke.py")
    offenders = [str(p) for p in sources if pattern in p.read_text()]
    assert not offenders, f"{pattern!r} found in {offenders}"
