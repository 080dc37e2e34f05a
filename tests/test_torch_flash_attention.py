"""The port's flash-attention plain version and dispatcher against the JAX ones.

`flash_attention_reference` is held against the JAX Pallas kernel run in
interpret mode (`flash_attention(..., interpret=True)` and
`flash_attention_with_lse`), as tests/test_ops.py runs it on the CPU.
f32 cases compare at atol = rtol = 1e-5 (summation order only); the bf16
case at atol 1e-2 (O is rounded to bf16, one ulp at 1 is 2**-8 ~ 4e-3).
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


def test_reference_matches_jax_kernel_bf16():
    """bf16: q prescaled in bf16, bf16 operands, p rounded to bf16 for PV.

    The JAX kernel in interpret mode on the CPU does not keep the bf16
    scores exact in f32 (its lse sits ~7e-4 from an exact numpy computation),
    so it is compared at the bf16 tolerance; the exact numpy computation of
    the same contract pins the lse at the f32 tolerance.
    """
    q, k, v = _qkv(2, 256, 200, 64, seed=3)
    scale = 0.125
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    j_out, j_lse = jflash_lse(jq, jk, jv, scale=scale, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out, lse = flash_attention_reference(tq, tk, tv, scale=scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(j_out, dtype=np.float32), **BF16_TOL
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **BF16_TOL)

    qs = np.asarray(jq * jnp.asarray(scale * 1.4426950408889634, jnp.bfloat16), np.float32)
    s = qs @ tk.float().numpy().transpose(0, 2, 1)
    exact_lse = np.log2(np.exp2(np.minimum(s, 80.0)).sum(-1)) * np.log(2.0)
    np.testing.assert_allclose(lse.numpy(), exact_lse, **F32_TOL)


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
