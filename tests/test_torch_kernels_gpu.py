"""The CUDA kernels against their plain versions: flash attention (kernels
1-4), the fused GroupNorm-SiLU-conv3d (kernel 5) and the two attention-forward
probes (kernels 6 and 7).

Imports neither JAX nor the JAX package, so it runs on a machine with a card
and no JAX. Tests marked `cuda` skip without a GPU; on the card run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_gpu.py

(`--noconftest`: tests/conftest.py configures JAX). Forward tolerances, as
chip_smoke.py's phase 2: O 1e-5 for f32 (summation order only; the 3xTF32
products keep f32 accuracy) and 2e-2 for bf16 (O rounded to bf16); the lse
1e-5 for f32 and 1e-4 for bf16 (an f32 log of the same row sums).
Backward (dq, dk, dv of kernels 2 and 3, and of the fused kernel 4),
relative to the largest gradient: 1e-4 for f32 (summation order over up to
1024 keys), 2e-2 for bf16. Kernel 4 against kernels 2 + 3 on the same
inputs: dk and dv equal to the bit (one body, the same mma order); dq
within 1e-5 of its largest value in f32 (f32 sums of the key blocks' parts
in key-block order), and in bf16 within one bf16 ulp of its value (those
sums may round to the other side of a bf16 tie) plus that 1e-5 (sums that
cancel). Kernels 2-4 compute s and dp by one function, kernel 2 with the
queries as the mma's A operand, kernels 3 and 4 with the keys: both roles
give the same s, dp and ds to the bit, so every bf16 ds rounds alike in
the three. Two launches of kernel 2, and two of kernel 4, give the same dq
to the bit.
Kernel 5, relative to the largest output, against a plain version whose
f32 convolution runs without TF32: 1e-5 for f32 (summation order of
27 * Cin products), 1e-2 for bf16 (the output is rounded to bf16, 2**-8 of
its value, and a rare activation rounds the other way at a tie).
Kernels 6 and 7, relative to the largest output: 2e-2 (bf16 output, p
rounded to bf16 after f32 sums in another order; the packed bf16 exp rounds
its argument to bf16); `mxu_only` on the rows whose plain row sum has
|l| >= 1, each against its own largest value (`relative_error`).
"""
from __future__ import annotations

import pytest
import torch

from generativemodels_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_BWD_FUSED,
    FLASH_FWD,
    FLASH_PROBE_OVERLAP,
    FLASH_PROBE_VPU,
    FUSED_CONV,
    OVERLAP_VARIANTS,
    VPU_VARIANTS,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_attention_with_lse,
    flash_overlap,
    flash_overlap_reference,
    flash_vpu,
    flash_vpu_reference,
    fused_norm_silu_conv3d,
    fused_norm_silu_conv3d_reference,
)
from generativemodels_tpu_torch.ops.flash_attention import (
    FLASH_BWD_ROLES,
    _backward_rows,
    _prescaled,
)
from generativemodels_tpu_torch.ops.flash_probes import relative_error


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


def test_roles_launcher_rejects_cpu_tensors():
    q = torch.zeros(2, 16, 64)
    rows = torch.zeros(2, 16)
    before = FLASH_BWD_ROLES.launches
    with pytest.raises(ValueError, match="CUDA"):
        FLASH_BWD_ROLES(q, q, q, q, rows, rows)
    assert FLASH_BWD_ROLES.launches == before


# (O, lse) tolerances of kernel 1, as chip_smoke.py's TOLERANCE and LSE_TOLERANCE
FWD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-4)}
# (BH, Sq, Sk, causal): Sq and Sk of the ragged case are no multiples of 64
FWD_SHAPES = {
    "self": (2, 512, 512, False),
    "causal": (2, 300, 300, True),
    "ragged": (3, 200, 333, False),
    "serve": (4, 1024, 1024, False),  # 256-wide heads only
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "case, d",
    [(c, d) for c in FWD_SHAPES for d in (32, 64, 128, 256) if c != "serve" or d == 256],
)
def test_kernel_matches_reference_on_gpu(cuda_device, case, d, dtype):
    bh, sq, sk, causal = FWD_SHAPES[case]
    g = torch.Generator(cuda_device).manual_seed(0)
    q, k, v = (
        torch.randn((bh, s, d), generator=g, device=cuda_device).to(dtype) for s in (sq, sk, sk)
    )
    before = FLASH_FWD.launches
    o, lse = FLASH_FWD(q, k, v, scale=d**-0.5, causal=causal)
    ref_o, ref_lse = flash_attention_reference(q, k, v, scale=d**-0.5, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    assert o.dtype == dtype and bool(torch.isfinite(o.float()).all())
    o_tol, lse_tol = FWD_TOL[dtype]
    assert (o.float() - ref_o.float()).abs().max().item() <= o_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype, causal, tol",
    [
        ((4, 1024, 1024, 256), torch.float32, False, 1e-4),
        ((4, 1024, 1024, 256), torch.bfloat16, False, 2e-2),
        ((2, 1000, 777, 64), torch.float32, False, 1e-4),
        ((2, 300, 300, 128), torch.float32, True, 1e-4),
        ((3, 70, 45, 32), torch.bfloat16, True, 2e-2),
    ]
    # every head width in both types; causal; and ragged, Sq and Sk no
    # multiples of kernel 3's q tile (32 or 64 rows) or key block (64 or 128)
    + [((2, 300, 300, d), dt, False, BWD_TOL[dt])
       for d in (32, 64, 128, 256) for dt in (torch.float32, torch.bfloat16)]
    + [((3, 257, 257, d), dt, True, BWD_TOL[dt])
       for d, dt in ((64, torch.bfloat16), (256, torch.float32))]
    + [((2, 200, 333, d), dt, False, BWD_TOL[dt])
       for d, dt in ((256, torch.bfloat16), (32, torch.float32))],
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


def _backward_inputs(device, bh, sq, sk, d, dtype, causal, seed=3):
    g = torch.Generator(device).manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=device).to(dtype) for s in (sq, sk, sk))
    dout = torch.randn((bh, sq, d), generator=g, device=device).to(dtype)
    out, lse2 = FLASH_FWD(q, k, v, scale=d**-0.5, causal=causal, log2_lse=True)
    return _prescaled(q, d**-0.5), k, v, out, lse2, dout


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "bh, sq, sk, causal",
    [(2, 300, 300, False), (2, 200, 333, False), (3, 257, 257, True)],
    ids=["self", "ragged", "causal"],
)
def test_fused_backward_kernel_on_gpu(cuda_device, monkeypatch, d, dtype, bh, sq, sk, causal):
    args = _backward_inputs(cuda_device, bh, sq, sk, d, dtype, causal)
    counters = (FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_FUSED)
    before = [c.launches for c in counters]
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    fused = flash_attention_backward(*args, causal=causal)
    again = flash_attention_backward(*args, causal=causal)
    torch.cuda.synchronize()
    # the switch launched kernel 4 alone
    assert [c.launches for c in counters] == [before[0], before[1], before[2] + 2]
    # dq's parts are added in key-block order: the same to the bit
    assert torch.equal(again[0], fused[0])
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "0")
    split = flash_attention_backward(*args, causal=causal)
    want = flash_attention_backward_reference(*args, causal=causal)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(fused, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= tol * b.float().abs().max().item()
    torch.testing.assert_close(fused[1], split[1], rtol=0, atol=0)
    torch.testing.assert_close(fused[2], split[2], rtol=0, atol=0)
    dq_f, dq_s = fused[0].float(), split[0].float()
    if dtype == torch.float32:
        assert (dq_f - dq_s).abs().max().item() <= 1e-5 * dq_s.abs().max().item()
    else:  # one bf16 ulp (2**-7 of the value's power of two) and the f32 margin
        ulp = torch.exp2(torch.floor(torch.log2(dq_s.abs().clamp_min(1e-30))) - 7)
        assert bool(((dq_f - dq_s).abs() <= ulp + 1e-5 * dq_s.abs().max()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sdp_roles_agree_to_the_bit_on_gpu(cuda_device, d, dtype):
    """The s, dp computation that kernels 2-4 share, on 64 random tiles of
    16 queries x 16 keys: query-major (A = Q, dO, as kernel 2) and key-major
    (A = K, V, as kernels 3 and 4) give the same bits of s, dp and ds; both
    near the plain products (the check is not empty)."""
    tiles = 64
    g = torch.Generator(cuda_device).manual_seed(6)
    q, k, v, dout = (torch.randn((tiles, 16, d), generator=g, device=cuda_device).to(dtype)
                     for _ in range(4))
    q = _prescaled(q, d**-0.5)
    s_ref = torch.matmul(q.float(), k.float().transpose(1, 2))
    dp_ref = torch.matmul(dout.float(), v.float().transpose(1, 2))
    lse2 = torch.logsumexp(s_ref * 0.6931471805599453, dim=-1) / 0.6931471805599453
    delta = torch.randn((tiles, 16), generator=g, device=cuda_device)
    before = FLASH_BWD_ROLES.launches
    out = FLASH_BWD_ROLES(q, k, v, dout, lse2, delta)
    torch.cuda.synchronize()
    assert FLASH_BWD_ROLES.launches == before + 1
    assert bool(torch.isfinite(out).all())
    query_major, key_major = out
    assert torch.equal(query_major.view(torch.int32), key_major.view(torch.int32))
    for got, want in zip(query_major[:2], (s_ref, dp_ref)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    ds_ref = torch.exp2(s_ref - lse2[..., None]) * (dp_ref - delta[..., None])
    assert (query_major[2] - ds_ref).abs().max().item() <= 1e-4 * ds_ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["ragged", "causal"])
def test_dq_kernel_is_deterministic_on_gpu(cuda_device, d, dtype, causal):
    """Kernel 2's dq rows belong to one block, whose key slices add in a
    fixed order: two launches agree to the bit."""
    qp, k, v, out, lse2, dout = _backward_inputs(cuda_device, 2, 300, 333, d, dtype, causal)
    do2, delta = _backward_rows(out, dout)
    before = FLASH_BWD_DQ.launches
    first = FLASH_BWD_DQ(qp, k, v, do2, lse2, delta, causal=causal)
    again = FLASH_BWD_DQ(qp, k, v, do2, lse2, delta, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_BWD_DQ.launches == before + 2
    assert bool(torch.isfinite(first.float()).all()) and first.float().abs().max().item() > 0
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), again.view(bits))


@pytest.mark.cuda
def test_unported_contracts_raise_on_gpu(cuda_device, monkeypatch):
    q = torch.randn(2, 64, 32, device=cuda_device)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, scale=0.1, upcast=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, scale=0.1, no_max=False)
    monkeypatch.setenv("GMTPU_FLASH_NOMAX", "0")  # the running-max contract, read at each call
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, scale=0.1)
    with pytest.raises(NotImplementedError):
        flash_attention_with_lse(q, q, q, scale=0.1)
    monkeypatch.delenv("GMTPU_FLASH_NOMAX")
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


def test_probe_launchers_reject_cpu_tensors():
    q = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    before = FLASH_PROBE_OVERLAP.launches, FLASH_PROBE_VPU.launches
    with pytest.raises(ValueError, match="CUDA"):
        FLASH_PROBE_OVERLAP(q, q, q, scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        FLASH_PROBE_VPU(q, q, q, scale=0.125, prescaled=True, bf16_p=True)
    assert (FLASH_PROBE_OVERLAP.launches, FLASH_PROBE_VPU.launches) == before


def _probe_inputs(device, bh, sq, sk, seed=4):
    g = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn((bh, s, 64), generator=g, device=device).to(torch.bfloat16)
                 for s in (sq, sk, sk))


PROBE_SHAPES = [(1, 128, 192), (2, 1024, 2048), (3, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", OVERLAP_VARIANTS)
@pytest.mark.parametrize("bh, sq, sk", PROBE_SHAPES)
def test_overlap_probe_kernel_on_gpu(cuda_device, variant, bh, sq, sk):
    q, k, v = _probe_inputs(cuda_device, bh, sq, sk)
    before = FLASH_PROBE_OVERLAP.launches
    got = flash_overlap(q, k, v, scale=0.125, variant=variant)
    want, l = flash_overlap_reference(q, k, v, scale=0.125, variant=variant, with_l=True)
    torch.cuda.synchronize()
    assert FLASH_PROBE_OVERLAP.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    err, rows = relative_error(got, want, l if variant == "mxu_only" else None)
    assert rows > 0 and err <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VPU_VARIANTS))
@pytest.mark.parametrize("bh, sq, sk", PROBE_SHAPES)
def test_vpu_probe_kernel_on_gpu(cuda_device, variant, bh, sq, sk):
    prescaled, bf16_p = VPU_VARIANTS[variant]
    q, k, v = _probe_inputs(cuda_device, bh, sq, sk, seed=5)
    before = FLASH_PROBE_VPU.launches
    got = flash_vpu(q, k, v, scale=0.125, prescaled=prescaled, bf16_p=bf16_p)
    want = flash_vpu_reference(q, k, v, scale=0.125, prescaled=prescaled, bf16_p=bf16_p)
    torch.cuda.synchronize()
    assert FLASH_PROBE_VPU.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert relative_error(got, want)[0] <= 2e-2


@pytest.mark.cuda
def test_probe_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(2, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    opts = dict(scale=0.125, prescaled=True, bf16_p=True)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_overlap(q.float(), q.float(), q.float(), scale=0.125)
    with pytest.raises(ValueError, match="multiples"):
        flash_overlap(q[:, :100], q, q, scale=0.125)
    with pytest.raises(ValueError, match="multiples"):  # q2 takes 128-row blocks
        flash_overlap(q[:, :64], q, q, scale=0.125, variant="q2")
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(2, 128, 128, device=cuda_device, dtype=torch.bfloat16)
        flash_vpu(wide[..., :64], q, q, **opts)
    with pytest.raises(ValueError, match="block_k"):
        flash_vpu(q, q, q, block_k=128, **opts)
    with pytest.raises(ValueError, match="device"):
        flash_vpu(q, q.cpu(), q.cpu(), **opts)
    with pytest.raises(ValueError, match="head width"):
        flash_overlap(q[..., :32].contiguous(), q[..., :32].contiguous(),
                      q[..., :32].contiguous(), scale=0.125)
