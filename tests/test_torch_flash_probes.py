"""The attention-forward probe kernels (kernels 6 and 7) of the port against
the JAX probes, on CPU.

The JAX side is benchmarks/probe_overlap.py and benchmarks/probe_attn_vpu.py,
loaded as they are, with their Pallas kernels run in interpret mode (their
module's `pl` replaced by a namespace whose `pallas_call` passes
`interpret=True`) and their tiles cut to 128 x 128. The port's side is the
public function on CPU tensors, i.e. the plain version. Inputs are bf16
(2, 512, 64) from a seeded numpy generator.

Tolerance: max|port - JAX| <= 1e-2 * max|JAX|. Both round p and the output
to bf16 (2**-8 of a value) after f32 sums taken in another order, so a p at
a rounding tie may land one bf16 ulp apart; the output moves far less than
1e-2 of its largest value. `mxu_only` (p = bf16(s), garbage by design) is
held on the rows where the plain row sum |l| >= 1, each against its own
largest value: where l comes near 0 the output divides by it (or by the
1e-30 floor) and summation order is amplified without bound. The VPU probe
depends on its key step (p is rounded against the running max), so the port
runs with block_k = 128, the JAX tile here.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from generativemodels_tpu_torch.ops import (
    OVERLAP_VARIANTS,
    VPU_VARIANTS,
    flash_overlap,
    flash_overlap_reference,
    flash_vpu,
    flash_vpu_reference,
)
from generativemodels_tpu_torch.ops.flash_probes import relative_error
from generativemodels_tpu_torch import probes
from generativemodels_tpu_torch.probes import probe_attn_vpu, probe_overlap
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
SHAPE = (2, 512, 64)
TILE = 128
TOL = 1e-2


def _load_jax_probe(name: str):
    """benchmarks/<name>.py with its Pallas calls in interpret mode. The script
    points JAX's compilation cache elsewhere when it is imported: the test
    process's settings are put back."""
    saved = {key: getattr(jax.config, key) for key in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
    module.pl = types.SimpleNamespace(
        **{**vars(pl), "pallas_call": functools.partial(pl.pallas_call, interpret=True)}
    )
    return module


@pytest.fixture(scope="module")
def jax_overlap():
    return _load_jax_probe("probe_overlap")


@pytest.fixture(scope="module")
def jax_vpu():
    return _load_jax_probe("probe_attn_vpu")


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(SHAPE, dtype=np.float32) for _ in range(3)]
    torch_in = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    # the same bf16 values on both sides
    jax_in = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in torch_in]
    return torch_in, jax_in


def _to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.mark.parametrize("variant", OVERLAP_VARIANTS)
def test_overlap_matches_jax_probe(jax_overlap, monkeypatch, variant):
    monkeypatch.setattr(jax_overlap, "BQ", TILE)
    monkeypatch.setattr(jax_overlap, "BK", TILE)
    (q, k, v), (jq, jk, jv) = _inputs()
    scale = SHAPE[2] ** -0.5
    want = _to_torch(jax_overlap.flash_var(jq, jk, jv, scale=scale, variant=variant))
    got = flash_overlap(q, k, v, scale=scale, variant=variant)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    l = None
    if variant == "mxu_only":
        _, l = flash_overlap_reference(q, k, v, scale=scale, variant=variant, with_l=True)
    err, rows = relative_error(got, want, l)
    assert rows >= 0.9 * SHAPE[0] * SHAPE[1]  # mxu_only: |l| >= 1 on most rows
    assert err <= TOL, f"{variant}: {err:.3e} over {rows} rows"


@pytest.mark.parametrize("variant", list(VPU_VARIANTS))
def test_vpu_matches_jax_probe(jax_vpu, monkeypatch, variant):
    monkeypatch.setattr(jax_vpu, "BQ", TILE)
    monkeypatch.setattr(jax_vpu, "BK", TILE)
    prescaled, bf16_p = VPU_VARIANTS[variant]
    (q, k, v), (jq, jk, jv) = _inputs(1)
    scale = SHAPE[2] ** -0.5
    want = _to_torch(jax_vpu.flash_var(jq, jk, jv, scale=scale, prescaled=prescaled,
                                       bf16_p=bf16_p))
    got = flash_vpu(q, k, v, scale=scale, prescaled=prescaled, bf16_p=bf16_p, block_k=TILE)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err, _ = relative_error(got, want)
    assert err <= TOL, f"{variant}: {err:.3e}"


def test_jax_bf16_exp2_is_exp_of_a_bf16_ln2_product():
    """The trap the bf16-domain variants copy: on bf16, jnp.exp2(x) is
    exp(x * bf16(ln 2)) with the product rounded to bf16, not a rounded
    2**x."""
    x = np.linspace(-10.0, 10.0, 2001, dtype=np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    want = _to_torch(jnp.exp2(jx))
    ln2 = torch.tensor(0.6931471805599453, dtype=torch.bfloat16)
    assert torch.equal(torch.exp(tx * ln2).float(), want)
    assert not torch.equal(torch.exp2(tx).float(), want)


def test_plain_versions_near_exact_softmax():
    """Every non-garbage variant is a softmax attention: within 2e-2 of the
    largest value of the exact f32 one (bf16dom rounds the log2 scores, up to
    ~6 here, to bf16's 2**-5 there, and its exp2 scales them by bf16(ln 2) /
    ln 2 = 0.9975: 1.1e-2 on these inputs; the others 3e-3 to 6.3e-3), and the
    row chunking does not change the result."""
    (q, k, v), _ = _inputs(2)
    scale = SHAPE[2] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    exact = torch.matmul(torch.softmax(s, dim=-1), v.float())
    outs = [flash_overlap_reference(q, k, v, scale=scale, variant=name)
            for name in OVERLAP_VARIANTS if name != "mxu_only"]
    outs += [flash_vpu_reference(q, k, v, scale=scale, prescaled=p, bf16_p=b, block_k=64)
             for p, b in VPU_VARIANTS.values()]
    for out in outs:
        assert (out.float() - exact).abs().max().item() <= 2e-2 * exact.abs().max().item()
    import generativemodels_tpu_torch.ops.flash_probes as fp

    whole = flash_vpu_reference(q, k, v, scale=scale, prescaled=False, bf16_p=True)
    whole_overlap = flash_overlap_reference(q, k, v, scale=scale, variant="full")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fp, "PLAIN_ELEMENTS", 2 * 64 * 512)  # 64-row chunks
        assert torch.equal(flash_vpu_reference(q, k, v, scale=scale, prescaled=False,
                                               bf16_p=True), whole)
        assert torch.equal(flash_overlap_reference(q, k, v, scale=scale, variant="full"),
                           whole_overlap)


def test_probes_reject_what_the_kernels_do_not_take():
    (q, k, v), _ = _inputs()
    with pytest.raises(ValueError, match="bfloat16"):
        flash_overlap(q.float(), k.float(), v.float(), scale=0.125)
    with pytest.raises(ValueError, match="head width"):
        flash_vpu(q[..., :32], k[..., :32], v[..., :32], scale=0.125, prescaled=True,
                  bf16_p=True)
    with pytest.raises(ValueError, match="multiples"):  # q2 takes 128-row blocks
        flash_overlap(q[:, :192], k, v, scale=0.125, variant="q2")
    with pytest.raises(ValueError, match="multiples"):
        flash_vpu(q, k[:, :320], v[:, :320], scale=0.125, prescaled=True, bf16_p=False,
                  block_k=128)
    with pytest.raises(ValueError, match="variant"):
        flash_overlap(q, k, v, scale=0.125, variant="ilv3")


def test_tile_multiples_are_what_each_probe_takes():
    """Kernel 6 zero-fills a last half key tile, so it takes Sk in 64s; kernel
    7's key step is its 128-key tile; q2 takes whole 128-row blocks."""
    from generativemodels_tpu_torch.ops.flash_probes import BLOCK_K, tile_multiples

    assert BLOCK_K == 128
    assert tile_multiples("full") == (64, 64)
    assert tile_multiples("q2") == (128, 64)
    assert tile_multiples("both") == (64, 128)
    (q, k, v), _ = _inputs()
    half = flash_overlap(q[:, :128], k[:, :192], v[:, :192], scale=0.125)
    assert half.shape == (2, 128, 64)
    with pytest.raises(ValueError, match="multiples"):
        flash_vpu(q[:, :128], k[:, :192], v[:, :192], scale=0.125, prescaled=True,
                  bf16_p=True)


@pytest.mark.parametrize(
    "variant, shape, want",
    [("full", (128, 192), (128, 192)), ("q2", (192, 320), (256, 320)),
     ("both", (128, 192), (128, 256)), ("prescale", (256, 64), (256, 128))],
)
def test_nearest_shape_rounds_up_to_each_kernels_tiles(variant, shape, want):
    """The shape a variant runs at where its kernel does not take a case's:
    a shape it takes is kept, and the plain version takes the rounded one."""
    from generativemodels_tpu_torch.ops.flash_probes import VPU_VARIANTS, nearest_shape

    assert nearest_shape(variant, *shape) == want
    assert nearest_shape(variant, *want) == want
    (q, k, v), _ = _inputs()
    sq, sk = want
    if variant in VPU_VARIANTS:
        prescaled, bf16_p = VPU_VARIANTS[variant]
        out = flash_vpu(q[:1, :sq], k[:1, :sk], v[:1, :sk], scale=0.125,
                        prescaled=prescaled, bf16_p=bf16_p)
    else:
        out = flash_overlap(q[:1, :sq], k[:1, :sk], v[:1, :sk], scale=0.125, variant=variant)
    assert out.shape == (1, sq, 64)


@pytest.mark.parametrize("probe", [probe_overlap, probe_attn_vpu], ids=["overlap", "vpu"])
def test_probe_main_on_cpu(probe, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(probe, "SEQ", 256)
    monkeypatch.setattr(probes, "ITERS", 1)
    out = tmp_path / "results.json"
    results = probe.main(["--device", "cpu", "--out", str(out)])
    assert [r["variant"] for r in results] == list(probe.VARIANTS)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == results == json.loads(out.read_text())
    for r in results:
        assert r["device"] == "cpu" and r["ms"] > 0
        # on CPU tensors the public function is the plain version
        assert r["maxdiff_vs_plain"] == 0.0
        if r["variant"] == "mxu_only":
            assert r["maxdiff_vs_einsum"] is None
        else:
            assert r["maxdiff_vs_einsum"] < 2e-2


@pytest.mark.parametrize("probe", [probe_overlap, probe_attn_vpu], ids=["overlap", "vpu"])
def test_probe_main_raises_where_the_tiles_do_not_divide(probe, monkeypatch):
    # the JAX scripts' grids (sq // BQ) would drop the last 36 tokens silently
    monkeypatch.setattr(probe, "SEQ", 100)
    with pytest.raises(ValueError, match="multiples"):
        probe.main(["--device", "cpu", probe.VARIANTS[-1]])


def test_probe_main_selects_variants_and_rejects_unknown(capsys):
    with pytest.raises(SystemExit):
        probe_overlap.main(["--device", "cpu", "ilv3"])
    assert "unknown variants" in capsys.readouterr().err
