"""The port's flash-attention backward against `jax.grad` of the JAX kernel.

The JAX side differentiates `flash_attention(..., interpret=True)`: its
custom VJP runs the Pallas backward kernels `_dq_kernel` and `_dkv_kernel`
in interpret mode, as tests/test_ops.py runs them on the CPU. The port's
side is checked twice: `flash_attention_backward_reference` called
directly, and the CPU gradients of `flash_attention` (its autograd Function,
which must not differentiate through the clamp). Same numpy inputs and
cotangent on both sides. f32 compares at rtol = 1e-5 and atol = 1e-5 times
the gradient's scale, max(1, max|grad|): summation order only. The scale
matters in the clamp case alone, where dk reaches 55 and both JAX and the
port sit 1.5e-4 from a float64 computation of the same contract (f32
accumulation over 256 terms of size ~20). The bf16 case compares at atol
2e-2 of the largest gradient (ds and the outputs are rounded to bf16, and
the JAX interpret mode does not keep bf16 scores exact in f32, see
test_torch_flash_attention.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.ops.flash_attention import flash_attention as jflash
from generativemodels_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_reference,
)
from generativemodels_tpu_torch.ops.flash_attention import LOG2E
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_TOL = 1e-5
BF16_REL = 2e-2

# name: (BH, Sq, Sk, D, causal, q multiplier)
CASES = {
    "self": (2, 256, 256, 64, False, 1.0),
    "cross_ragged": (2, 128, 200, 32, False, 1.0),
    "causal": (2, 256, 256, 64, True, 1.0),
    # natural logits up to ~100x normal: the forward clamps at log2 score 80,
    # and the backward must treat the clamp as the identity
    "clamp": (2, 256, 256, 64, False, 100.0),
}


def _inputs(bh, sq, sk, d, mult=1.0, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) for s in (sq, sk, sk))
    g = rng.standard_normal((bh, sq, d)).astype(np.float32)
    return q * np.float32(mult), k, v, g


def _jax_grads(q, k, v, g, *, scale, causal, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype=dtype) for a in (q, k, v)]

    def f(q, k, v):
        out = jflash(q, k, v, scale=scale, causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    return [np.asarray(x, dtype=np.float32) for x in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, g, *, scale, causal, dtype=torch.float32):
    qkv = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*qkv, scale=scale, causal=causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [t.grad.float().numpy() for t in qkv]


def _reference_grads(q, k, v, g, *, scale, causal, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    c = torch.tensor(scale * LOG2E, dtype=dtype)
    out, lse2 = flash_attention_reference(tq, tk, tv, scale=scale, causal=causal, log2_lse=True)
    dq, dk, dv = flash_attention_backward_reference(
        tq * c, tk, tv, out, lse2, torch.from_numpy(g).to(dtype), causal=causal
    )
    return [t.float().numpy() for t in (dq * c, dk, dv)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax(name):
    bh, sq, sk, d, causal, mult = CASES[name]
    q, k, v, g = _inputs(bh, sq, sk, d, mult)
    scale = d**-0.5
    want = _jax_grads(q, k, v, g, scale=scale, causal=causal)
    for got in (
        _reference_grads(q, k, v, g, scale=scale, causal=causal),
        _port_grads(q, k, v, g, scale=scale, causal=causal),
    ):
        for w, x, label in zip(want, got, ("dq", "dk", "dv")):
            scale_of_w = np.abs(w).max()
            assert scale_of_w > 1e-3, label  # the check is not empty
            np.testing.assert_allclose(
                x, w, rtol=F32_TOL, atol=F32_TOL * max(1.0, scale_of_w), err_msg=label
            )


def test_backward_matches_jax_bf16():
    q, k, v, g = _inputs(2, 256, 200, 64, seed=3)
    scale = 0.125
    want = _jax_grads(q, k, v, g, scale=scale, causal=False, dtype=jnp.bfloat16)
    for got in (
        _reference_grads(q, k, v, g, scale=scale, causal=False, dtype=torch.bfloat16),
        _port_grads(q, k, v, g, scale=scale, causal=False, dtype=torch.bfloat16),
    ):
        for w, x, label in zip(want, got, ("dq", "dk", "dv")):
            assert np.abs(x - w).max() <= BF16_REL * np.abs(w).max(), label


def test_cpu_gradients_launch_no_kernel():
    q, k, v, g = _inputs(2, 96, 80, 32, seed=2)
    counters = (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV)
    before = [c.launches for c in counters]
    grads = _port_grads(q, k, v, g, scale=0.2, causal=False)
    assert all(np.isfinite(x).all() for x in grads)
    assert [c.launches for c in counters] == before
