"""The CUDA kernels against their plain versions: flash attention (kernels
1-3) and the fused GroupNorm-SiLU-conv3d (kernel 5).

Imports neither JAX nor the JAX package, so it runs on a machine with a card
and no JAX. Tests marked `cuda` skip without a GPU; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py

(`--noconftest`: tests/conftest.py configures JAX). Forward tolerances:
1e-5 for f32 (summation order only), 2e-2 for bf16 (O rounded to bf16).
Backward (dq, dk, dv of kernels 2 and 3), relative to the largest gradient:
1e-4 for f32 (summation order over up to 1024 keys), 2e-2 for bf16.
Kernel 5, relative to the largest output, against a plain version whose
f32 convolution runs without TF32: 1e-5 for f32 (summation order of
27 * Cin products), 1e-2 for bf16 (the output is rounded to bf16, 2**-8 of
its value, and a rare activation rounds the other way at a tie).
"""
from __future__ import annotations

import pytest
import torch

from generativemodels_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    FUSED_CONV,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_attention_with_lse,
    fused_norm_silu_conv3d,
    fused_norm_silu_conv3d_reference,
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


def test_fused_conv_launcher_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 4, 4, 8)
    before = FUSED_CONV.launches
    with pytest.raises(ValueError, match="CUDA"):
        FUSED_CONV(x, torch.zeros(3, 3, 3, 8, 8), torch.ones(1, 8), torch.zeros(1, 8),
                   torch.zeros(8))
    assert FUSED_CONV.launches == before


def _conv_inputs(device, b, d, h, w, cin, cout, dtype, channels_first, res_dtype):
    g = torch.Generator(device).manual_seed(2)

    def rand(*shape, mul=1.0):
        return mul * torch.randn(shape, generator=g, device=device)

    x = rand(b, cin, d, h, w) if channels_first else rand(b, d, h, w, cin)
    x = x.to(dtype)
    if channels_first:
        x = x.permute(0, 2, 3, 4, 1)
    res = None
    if res_dtype is not None:
        res = rand(b, cout, d, h, w).to(res_dtype).permute(0, 2, 3, 4, 1)
    return (x, rand(3, 3, 3, cin, cout, mul=(27 * cin) ** -0.5).to(dtype),
            1.0 + 0.1 * rand(b, cin), 0.1 * rand(b, cin), 0.1 * rand(cout), res)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype, channels_first, res_dtype, apply_act",
    [
        ((1, 8, 16, 32, 32, 32), torch.float32, False, None, True),
        ((1, 8, 16, 32, 32, 32), torch.bfloat16, True, torch.bfloat16, True),
        ((2, 5, 7, 9, 40, 24), torch.float32, True, torch.float32, True),  # ragged
        ((2, 5, 7, 9, 40, 24), torch.bfloat16, False, torch.float32, False),
        ((1, 4, 6, 33, 96, 64), torch.bfloat16, True, None, True),
        ((1, 4, 8, 8, 64, 128), torch.float32, True, torch.float32, True),
        ((1, 3, 4, 70, 8, 130), torch.bfloat16, False, torch.bfloat16, True),  # 2 Cout tiles
    ],
)
def test_fused_conv_matches_reference_on_gpu(cuda_device, monkeypatch, shape, dtype,
                                             channels_first, res_dtype, apply_act):
    # the plain version's f32 convolution in full f32: cuDNN takes TF32 by default
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w, scale, shift, bias, res = _conv_inputs(cuda_device, *shape, dtype, channels_first,
                                                 res_dtype)
    before = FUSED_CONV.launches
    got = fused_norm_silu_conv3d(x, w, scale, shift, bias, res, apply_act=apply_act)
    want = fused_norm_silu_conv3d_reference(x, w, scale, shift, bias, res, apply_act)
    torch.cuda.synchronize()
    assert FUSED_CONV.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    if channels_first:  # the output keeps x's channels-first memory
        assert got.permute(0, 4, 1, 2, 3).is_contiguous()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.cuda
def test_fused_conv_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(1, 4, 4, 4, 8, device=cuda_device)
    w = torch.zeros(3, 3, 3, 8, 8, device=cuda_device)
    one, zero = torch.ones(1, 8, device=cuda_device), torch.zeros(8, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FUSED_CONV(x.half(), w.half(), one, one, zero)
    with pytest.raises(ValueError, match="contiguous"):
        FUSED_CONV(x[:, :, :, ::2], w, one, one, zero)
    with pytest.raises(ValueError, match="scale"):
        FUSED_CONV(x, w, torch.ones(1, 4, device=cuda_device), one, zero)
