"""The port stands alone: it imports no JAX, calls no finished attention kernel
and never loads the JAX package's data library (native/libgmtpu_data.so; the
port builds its own loader, tests/test_torch_data.py checks the process maps).

Nor do chip_smoke.py and smoke_data_path.py, but chip_smoke.py may name
`scaled_dot_product_attention` only inside
`library_attention_ms`, which times it as a yardstick beside kernels 1-3
and is never called by the port.
"""
from __future__ import annotations

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import generativemodels_tpu_torch

PORT_DIR = Path(generativemodels_tpu_torch.__file__).parent
REPO = PORT_DIR.parent
# libgmtpu_data: the JAX package's loader library (native/); the port builds its own
FORBIDDEN = ("scaled_dot_product_attention", "torch.compile", "import jax", "from jax",
             "libgmtpu_data")
SDPA = "scaled_dot_product_attention"
YARDSTICK = "library_attention_ms"


def _port_modules() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PORT_DIR)], prefix="generativemodels_tpu_torch.")
    )


def test_port_modules_import_without_jax():
    modules = _port_modules()
    for name in ("recipes.serve", "recipes.train_2d_ddpm", "parallel.train", "utils.profiling",
                 "probes.probe_overlap", "networks.nets.autoencoderkl", "inferers.latent",
                 "networks.schedulers.pndm", "probes.bench_3d_ldm",
                 "networks.blocks.mlp", "networks.blocks.attention_blocks",
                 "networks.nets.controlnet", "inferers.controlnet", "recipes.guidance",
                 "recipes.brain_ldm_sampler", "networks.layers.vector_quantizer",
                 "networks.nets.vqvae", "networks.nets.patchgan_discriminator",
                 "losses.adversarial_loss", "losses.spectral_loss", "engines.trainer",
                 "engines.prepare_batch", "recipes.train_vqgan", "recipes.train_2d_ldm",
                 "recipes.train_3d_ldm", "networks.backbones", "networks.pretrained",
                 "losses.perceptual", "utils.ordering", "networks.blocks.selfattention",
                 "networks.nets.transformer", "inferers.vqvae_transformer",
                 "recipes.train_vqvae_transformer", "networks.blocks.spade_norm",
                 "networks.blocks.encoder_modules", "networks.nets.spade_autoencoderkl",
                 "networks.nets.spade_diffusion_model_unet", "networks.nets.spade_network",
                 "recipes.train_spade_vae", "recipes.train_spade_ldm", "metrics.fid",
                 "metrics.mmd", "metrics.ssim", "config.parser", "config.bundle_compat",
                 "data.native", "data.pipeline", "data.transforms", "utils.checkpoint",
                 "utils.guards", "utils.logging", "recipes.data_flags", "recipes.eval_quality",
                 "recipes.eval_brain_ldm"):
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


def _outside_yardstick(source: str) -> str:
    """chip_smoke.py's source with the yardstick function's lines blanked."""
    lines = source.splitlines()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.FunctionDef) and node.name == YARDSTICK:
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = ""
    return "\n".join(lines)


@pytest.mark.parametrize("pattern", FORBIDDEN)
def test_port_sources_avoid(pattern):
    sources = {p: p.read_text() for p in PORT_DIR.rglob("*")
               if p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp", ".json")}
    for script in ("chip_smoke.py", "smoke_data_path.py"):
        sources[REPO / script] = (REPO / script).read_text()
    smoke = REPO / "chip_smoke.py"
    if pattern == SDPA:
        sources[smoke] = _outside_yardstick(sources[smoke])
    offenders = [str(p) for p, text in sources.items() if pattern in text]
    assert not offenders, f"{pattern!r} found in {offenders}"


def test_yardstick_blanking_finds_sdpa_outside_the_function():
    inside = f"def {YARDSTICK}(torch):\n    return torch.nn.functional.{SDPA}\n"
    assert SDPA not in _outside_yardstick(inside)
    assert SDPA in _outside_yardstick(inside + f"x = {SDPA}\n")
