"""The port's flash-attention plain version and dispatcher against the JAX ones.

`flash_attention_reference` is held against the JAX Pallas kernel run in
interpret mode (`flash_attention(..., interpret=True)` and
`flash_attention_with_lse`), as tests/test_ops.py runs it on the CPU.
f32 cases compare at atol = rtol = 1e-5 (summation order only); bf16 O at
atol 1e-2 (O is rounded to bf16, one ulp at 1 is 2**-8 ~ 4e-3), the bf16
lse at the f32 tolerance (an f32 log of the same sums).
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py and by chip_smoke.py.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.ops import attention as jattention
from generativemodels_tpu.ops.flash_attention import (
    flash_attention as jflash,
    flash_attention_with_lse as jflash_lse,
)
from generativemodels_tpu_torch.ops import (
    FLASH_FWD,
    dot_product_attention,
    flash_attention,
    flash_attention_reference,
    flash_attention_with_lse,
    resolve_use_flash,
)

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=0)

# name: (BH, Sq, Sk, D, causal, q multiplier)
CASES = {
    "self": (2, 256, 256, 64, False, 1.0),
    "cross_ragged": (2, 128, 200, 32, False, 1.0),
    "causal": (2, 256, 256, 64, True, 1.0),
    "clamp": (2, 256, 256, 64, False, 100.0),
}


def _qkv(bh, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.standard_normal((bh, s, d)).astype(np.float32) for s in (sq, sk, sk)
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_kernel(name):
    bh, sq, sk, d, causal, mult = CASES[name]
    q, k, v = _qkv(bh, sq, sk, d)
    q = q * mult
    scale = d**-0.5
    j_out = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, causal=causal,
                   interpret=True)
    out, lse = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale, causal=causal
    )
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)
    if not causal:
        j_out2, j_lse = jflash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
                                   interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out2), **F32_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **F32_TOL)


def _exact_lse_bf16(q, k, scale, d, causal=False):
    """The bf16 contract's lse in f64 numpy from the bf16-rounded prescaled
    q and k: l sums p rounded to bf16 at D % 128 != 0 (JAX's `fold_l`
    ones column of V), the unrounded p at D % 128 == 0."""
    qs = np.asarray(
        jnp.asarray(q, jnp.bfloat16) * jnp.asarray(scale * 1.4426950408889634, jnp.bfloat16),
        np.float64,
    )
    kb = np.asarray(jnp.asarray(k, jnp.bfloat16), np.float64)
    p = np.exp2(np.minimum(qs @ kb.transpose(0, 2, 1), 80.0)).astype(np.float32)
    if causal:
        p = p * np.tril(np.ones(p.shape[1:], np.float32))
    if d % 128:
        p = np.asarray(jnp.asarray(p, jnp.bfloat16), np.float32)
    return np.log2(p.astype(np.float64).sum(-1)) * np.log(2.0)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_reference_matches_jax_kernel_bf16(d):
    """bf16: q prescaled in bf16, bf16 operands, p rounded to bf16 for PV,
    and the row sum l by head width (JAX's `fold_l`): at D % 128 != 0 the
    sum of the bf16-rounded p, at D % 128 == 0 of the unrounded p.

    The lse is held to JAX's `flash_attention_with_lse` (interpret mode)
    at the f32 tolerance: on these inputs the two sit at most 9.5e-7 apart
    at every D (my CPU run). The rule matters: summing the other p moves
    the lse by ~8e-4 here. Where an exp2 lands within an ulp of a bf16
    rounding tie the two libraries may round one p to either side (seed 4
    at D = 64: 2.0e-4 from one p holding 3% of its row), so the inputs are
    fixed. O is rounded to bf16 and compared at the bf16 tolerance. The
    exact f64 computation of the same contract pins the lse at the f32
    tolerance too.
    """
    q, k, v = _qkv(2, 256, 200, d, seed=3)
    scale = d**-0.5
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    j_out, j_lse = jflash_lse(jq, jk, jv, scale=scale, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = flash_attention_reference(tq, tk, tv, scale=scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(j_out, dtype=np.float32), **BF16_TOL
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), _exact_lse_bf16(q, k, scale, d), **F32_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_reference_matches_jax_kernel_bf16_causal(d):
    """The causal bf16 contract: O against JAX's `flash_attention` in
    interpret mode (it returns no lse), the lse against the exact f64
    computation with the same mask and row-sum rule."""
    q, k, v = _qkv(2, 256, 256, d, seed=6)
    scale = d**-0.5
    j_out = jflash(*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)), scale=scale,
                   causal=True, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = flash_attention_reference(tq, tk, tv, scale=scale, causal=True)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(j_out, dtype=np.float32), **BF16_TOL
    )
    np.testing.assert_allclose(lse.numpy(), _exact_lse_bf16(q, k, scale, d, causal=True),
                               **F32_TOL)


@pytest.mark.parametrize("upcast, no_max", [(True, True), (False, False)])
def test_reference_other_contracts_match_jax(upcast, no_max):
    """`upcast` (f32, natural log, running max) and the running-max log2 mode."""
    q, k, v = _qkv(2, 160, 160, 32, seed=5)
    scale = 32**-0.5
    j_out = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, interpret=True,
                   upcast=upcast, no_max=no_max)
    out, _ = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=scale,
        upcast=upcast, no_max=no_max,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)


def test_nomax_variable_matches_jax(monkeypatch):
    """GMTPU_FLASH_NOMAX, read at each call by `flash_attention` and
    `flash_attention_with_lse` in both packages: =0 gives JAX's running-max
    result, unset or =1 its clamped one. The logits (q x 30) pass the
    clamp, so the two settings give different results."""
    q, k, v = _qkv(2, 160, 160, 32, seed=8)
    q = q * 30.0
    scale = 32**-0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    outs = {}
    for setting in ("0", "1"):
        monkeypatch.setenv("GMTPU_FLASH_NOMAX", setting)
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        j_out = jflash(jq, jk, jv, scale=scale, interpret=True)
        j_out2, j_lse = jflash_lse(jq, jk, jv, scale=scale, interpret=True)
        out = flash_attention(tq, tk, tv, scale=scale)
        out2, lse = flash_attention_with_lse(tq, tk, tv, scale=scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)
        np.testing.assert_allclose(out2.numpy(), np.asarray(j_out2), **F32_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **F32_TOL)
        outs[setting] = out
    monkeypatch.delenv("GMTPU_FLASH_NOMAX")
    torch.testing.assert_close(flash_attention(tq, tk, tv, scale=scale), outs["1"], rtol=0,
                               atol=0)
    assert (outs["0"] - outs["1"]).abs().max().item() > 1e-2
    # an explicit argument wins over the variable
    monkeypatch.setenv("GMTPU_FLASH_NOMAX", "0")
    torch.testing.assert_close(flash_attention(tq, tk, tv, scale=scale, no_max=True), outs["1"],
                               rtol=0, atol=0)


def test_cpu_wrappers_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 96, 80, 32, seed=2))
    ref_o, ref_lse = flash_attention_reference(q, k, v, scale=0.2)
    before = FLASH_FWD.launches
    torch.testing.assert_close(flash_attention(q, k, v, scale=0.2), ref_o, rtol=0, atol=0)
    o, lse = flash_attention_with_lse(q, k, v, scale=0.2)
    torch.testing.assert_close(o, ref_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    assert FLASH_FWD.launches == before  # no kernel launch for CPU tensors


@pytest.mark.parametrize("use_flash", [True, False, None])
@pytest.mark.parametrize("heads, causal", [(1, False), (4, False), (2, True)])
def test_dot_product_attention_matches_jax(use_flash, heads, causal):
    rng = np.random.RandomState(11)
    q, k, v = (rng.standard_normal((2, 160, 64)).astype(np.float32) for _ in range(3))
    j_out = jattention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, causal=causal,
        use_flash=use_flash,
    )
    out = dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads, causal=causal,
        use_flash=use_flash,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_TOL)


def test_resolve_use_flash_table_matches_jax():
    """Same decisions as the JAX rule, with 'on TPU' read as 'on CUDA', over
    the head widths the kernel is built for and one above the limit."""
    for seq, head_dim, use_flash, on in itertools.product(
        (256, 1023, 1024, 4096), (32, 64, 128, 256, 512), (None, True, False), (True, False)
    ):
        assert resolve_use_flash(seq, head_dim, use_flash, on_cuda=on) == (
            jattention.resolve_use_flash(seq, head_dim, use_flash, on_tpu=on)
        ), (seq, head_dim, use_flash, on)
    # a width the JAX rule admits but the kernel is not built for stays plain
    assert not resolve_use_flash(1024, 48, None, on_cuda=True)
