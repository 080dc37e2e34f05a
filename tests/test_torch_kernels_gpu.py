"""The CUDA flash-attention kernels against their plain versions.

Imports neither JAX nor the JAX package, so it runs on a machine with a card
and no JAX. Tests marked `cuda` skip without a GPU; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py

(`--noconftest`: tests/conftest.py configures JAX). Forward tolerances:
1e-5 for f32 (summation order only), 2e-2 for bf16 (O rounded to bf16).
Backward (dq, dk, dv of kernels 2 and 3), relative to the largest gradient:
1e-4 for f32 (summation order over up to 1024 keys), 2e-2 for bf16.
"""
from __future__ import annotations

import pytest
import torch

from generativemodels_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)
from generativemodels_tpu_torch.ops.flash_attention import _prescaled


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_launcher_rejects_cpu_tensors():
    q = torch.zeros(1, 32, 64)
    before = FLASH_FWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        FLASH_FWD(q, q, q, scale=0.125)
    assert FLASH_FWD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype, causal, tol",
    [
        ((4, 1024, 1024, 256), torch.float32, False, 1e-5),
        ((4, 1024, 1024, 256), torch.bfloat16, False, 2e-2),
        ((2, 1000, 777, 64), torch.float32, False, 1e-5),
        ((2, 300, 300, 128), torch.float32, True, 1e-5),
        ((3, 70, 45, 32), torch.float32, False, 1e-5),
    ],
)
def test_kernel_matches_reference_on_gpu(cuda_device, shape, dtype, causal, tol):
    bh, sq, sk, d = shape
    g = torch.Generator(cuda_device).manual_seed(0)
    q, k, v = (
        torch.randn((bh, s, d), generator=g, device=cuda_device).to(dtype) for s in (sq, sk, sk)
    )
    before = FLASH_FWD.launches
    o, lse = FLASH_FWD(q, k, v, scale=d**-0.5, causal=causal)
    ref_o, ref_lse = flash_attention_reference(q, k, v, scale=d**-0.5, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    assert (o.float() - ref_o.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype, causal, tol",
    [
        ((4, 1024, 1024, 256), torch.float32, False, 1e-4),
        ((4, 1024, 1024, 256), torch.bfloat16, False, 2e-2),
        ((2, 1000, 777, 64), torch.float32, False, 1e-4),
        ((2, 300, 300, 128), torch.float32, True, 1e-4),
        ((3, 70, 45, 32), torch.bfloat16, True, 2e-2),
    ],
)
def test_backward_kernels_match_reference_on_gpu(cuda_device, shape, dtype, causal, tol):
    bh, sq, sk, d = shape
    g = torch.Generator(cuda_device).manual_seed(1)
    q, k, v = (
        torch.randn((bh, s, d), generator=g, device=cuda_device).to(dtype) for s in (sq, sk, sk)
    )
    dout = torch.randn((bh, sq, d), generator=g, device=cuda_device).to(dtype)
    out, lse2 = FLASH_FWD(q, k, v, scale=d**-0.5, causal=causal, log2_lse=True)
    qp = _prescaled(q, d**-0.5)
    before = FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches
    got = flash_attention_backward(qp, k, v, out, lse2, dout, causal=causal)
    want = flash_attention_backward_reference(qp, k, v, out, lse2, dout, causal=causal)
    torch.cuda.synchronize()
    assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()


@pytest.mark.cuda
def test_unported_contracts_raise_on_gpu(cuda_device):
    q = torch.randn(2, 64, 32, device=cuda_device)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, scale=0.1, upcast=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, scale=0.1, no_max=False)
    with pytest.raises(NotImplementedError):
        flash_attention_with_lse(q.clone().requires_grad_(), q, q, scale=0.1)
    # a gradient now runs the backward kernels
    qg = q.clone().requires_grad_()
    before = FLASH_FWD.launches, FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches
    flash_attention(qg, q, q, scale=0.1).sum().backward()
    torch.cuda.synchronize()
    after = FLASH_FWD.launches, FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches
    assert after == tuple(n + 1 for n in before)
    assert bool(torch.isfinite(qg.grad).all())
    with pytest.raises(ValueError, match="head width"):
        FLASH_FWD(q[..., :16].contiguous(), q[..., :16].contiguous(), q[..., :16].contiguous(),
                  scale=0.1)
