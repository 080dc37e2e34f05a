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
inputs: dk and dv equal to the bit where the two run one body of
`attention_route` (the mma.sync body the two share, and on the wgmma
routes, bf16 at D = 64 and 256, and the TF32 route at f32 D = 64, the
same dV and dK products in the same order), and where they do not (f32 D
= 128 and 256, where kernel 3 runs its TF32 wgmma body and kernel 4
mma.sync), within the fused margin below (the same products summed in
another order); dq within 1e-5 of its
largest value in f32 (f32 sums of the key blocks' parts in key-block
order), and in bf16 within one bf16 ulp of its value (those sums may round
to the other side of a bf16 tie) plus that 1e-5 (sums that cancel). The
wgmma route of kernels 1-4 against the plain versions in both exp2
contracts, the D = 256 wgmma bodies of kernels 1-3 (bf16 at D = 256)
in both, and the TF32 routes of kernels 2 and 3 (f32 at D = 64, 128 and
256) and kernel 1 (f32 at D = 128 and 256) in all three, causal, ragged,
Sk = 1 and 77 and Sq below and above Sk, two launches equal to the bit,
kernel 1's key split (a cluster of two blocks at the serving shape)
against an unsplit launch; the profiler names the D = 256 bodies'
kernels, and the f32 D = 128 and 256 bodies', as the ones that ran; each
(kernel, input) takes one body, so the C entries refuse the routes the
inputs do not take (`test_backward_route_refused_on_gpu`) and an unknown
route. Kernels 2-4
compute s and dp by one function, kernel 2 with the
queries as the mma's A operand, kernels 3 and 4 with the keys: both roles
give the same s, dp and ds to the bit, so every bf16 ds rounds alike in
the three. Two launches of kernel 2, and two of kernel 4, give the same dq
to the bit. Kernels 1-4 under the JAX kernel's other two contracts
(`upcast=True`, and the running max of `no_max=False` or
GMTPU_FLASH_NOMAX=0), at the same tolerances, with Sk = 1 and 77 (the
conditioned UNets' cross-attention) among the shapes: the lse relative to
max(1, max|lse|), and at Sk = 1 dq and dk, which are 0 in exact
arithmetic, relative to the size of the terms that cancel in them. A
scheduler moved to the card by `set_timesteps(n, device="cuda")` takes a
step there.
Kernel 5 (the brain LDM UNet's shapes among its cases), relative to the
largest output, against a plain version whose f32 convolution runs
without TF32: 1e-5 for f32 (summation order of
27 * Cin products), 1e-2 for bf16 (the output is rounded to bf16, 2**-8 of
its value, and a rare activation rounds the other way at a tie); two
launches of the bf16 kernel give the same bits.
The latent route's modules on the card against the same modules on the CPU
(AutoencoderKL with attention at 4096 tokens, so kernel 1 runs in it; the
latent UNet with and without the fused ResnetBlock route), relative to the
largest output: 1e-4 in f32 (chip_smoke.py's kernel-path forward check),
and in bf16 twice the CPU bf16 run's own distance from the CPU f32 run. A
PNDM chain on the card within 1e-5 of its largest value of the CPU's.
The 3D LDM recipe's AEKL attention block (64 channels, one head of 64) at
its two f32 shapes, 32^3 and 16^3 tokens a volume at batch 2, forward and
backward through kernels 1-3 (and 1 and 4) against the plain attention path
on the card: the output within 1e-4 of its largest value, each parameter's
and the input's gradient within 1e-3 of its largest (chip_smoke.py's
kernel-path checks). One adversarial stage-1 step (a narrowed 3D AEKL with
attention at 4096 tokens and a BatchNorm PatchGAN, the latent draw given)
on the card against the same step on the CPU: the losses at rtol 1e-4, the
parameters and D's statistics after Adam (eps 1e-3) at atol 1e-6 + rtol
1e-4. The brain sampler with no device samples on the card.
Kernels 6 and 7, relative to the largest output: 2e-2 (bf16 output, p
rounded to bf16 after f32 sums in another order; the packed bf16 exp rounds
its argument to bf16); `mxu_only` on the rows whose plain row sum has
|l| >= 1, each against its own largest value (`relative_error`).
The autoregressive stack's causal contract at head width 32: kernels 1-3
(and 4) at (8, 1024, 1024, 32) f32 causal against the plain versions at the
tolerances above; the recipe's transformer (dim 128, 4 heads) at 1024
tokens, one training forward and backward on the kernels against the plain
attention path (logits within 1e-4, gradients within 1e-3 of their largest
value); greedy sampling on the card equal on the windowed and the cached
paths; the AR and SPADE recipes on the card by default.
The sequence-parallel pieces (ops/sharded_attention.py, chip_smoke.py's
phase 15 (b) at smaller shapes): kernel 1 and kernel 2 at Sq = S/n, Sk = S
give the unsharded kernels' rows to the bit, kernel 3's dk, dv over the n
query blocks sum to the unsharded ones within the backward tolerance; the
ring's n chunks of kernel 1 with its lse, merged by `_combine_chunks` on
the card, within 1e-5 (f32) or 2e-2 of the largest |O| (bf16: a few ulps
there) of the unsharded O; kernel 5 on the
halo slabs of a cut volume, cropped, equal to the unsharded output to the
bit.
The host data path on the card's machine: the port's loader (built there
without the decoders whose headers are missing) in file order and in the
seeded shuffle order, batches landing on the card equal to the host
stream, and the metrics on the card against the CPU (tolerances beside
those tests).
"""
from __future__ import annotations

import copy
import sys

import numpy as np
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
    ROUTE_MMA,
    ROUTE_TF32,
    ROUTE_WGMMA,
    _backward_rows,
    _prescaled,
    attention_route,
)
from generativemodels_tpu_torch.ops import fused_conv as fused_conv_module
from generativemodels_tpu_torch.ops.flash_probes import nearest_shape, relative_error
from generativemodels_tpu_torch.ops.fused_conv import CONV_BN, CONV_RUNS
from generativemodels_tpu_torch import engines
from generativemodels_tpu_torch.networks.blocks import AttentionBlock
from generativemodels_tpu_torch.networks.nets import (
    AutoencoderKL,
    DiffusionModelUNet,
    PatchDiscriminator,
)
from generativemodels_tpu_torch.networks.schedulers import DDIMScheduler, PNDMScheduler
from generativemodels_tpu_torch.recipes import brain_ldm_sampler, train_2d_ldm
from generativemodels_tpu_torch.recipes import train_spade_ldm, train_spade_vae
from generativemodels_tpu_torch.recipes import train_vqvae_transformer
from generativemodels_tpu_torch.inferers import VQVAETransformerInferer
from generativemodels_tpu_torch.networks.nets import DecoderOnlyTransformer
from generativemodels_tpu_torch.utils import Ordering


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
    _assert_fused_dkv_agree(fused, split, dtype, d)
    _assert_within_fused_margin(fused[0], split[0])


def _assert_within_fused_margin(got, want, size=None):
    """Kernel 4's dq against kernel 2's (and its dk, dv against kernel 3's
    where the two run different bodies): the same f32 products summed in
    another order, within 1e-5 of the largest value in f32, and in bf16
    within one bf16 ulp (2**-7 of the value's power of two) plus that
    margin. `size` stands in for the largest value where a gradient
    cancels to rounding (`_gradient_sizes`: dq and dk at Sk = 1)."""
    a, b = got.float(), want.float()
    scale = b.abs().max().item() if size is None else size
    if want.dtype == torch.float32:
        assert (a - b).abs().max().item() <= 1e-5 * scale
    else:
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
        assert bool(((a - b).abs() <= ulp + 1e-5 * scale).all())


def _assert_fused_dkv_agree(fused, split, dtype, d, upcast=False, sizes=(None,) * 3):
    """Kernel 4's dk, dv against kernel 3's: equal to the bit where the two
    run one body (each runs kernel 3's dV and dK products in kernel 3's
    order: the mma.sync, wgmma and TF32 routes at f32 D = 64); at f32 D =
    128 and 256 (kernel 3 on its TF32 body, kernel 4 on mma.sync) within
    the fused margin, as kernel 4's dq is held (`sizes`: `_gradient_sizes`,
    where dk cancels to rounding)."""
    if (attention_route(dtype, d, upcast, kernel="flash_bwd_dkv")
            == attention_route(dtype, d, upcast, kernel="flash_bwd_fused")):
        torch.testing.assert_close(fused[1], split[1], rtol=0, atol=0)
        torch.testing.assert_close(fused[2], split[2], rtol=0, atol=0)
    else:
        _assert_within_fused_margin(fused[1], split[1], sizes[1])
        _assert_within_fused_margin(fused[2], split[2], sizes[2])


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
    """The JAX kernel's other two contracts (`upcast=True`, and the running
    max of `no_max=False` or GMTPU_FLASH_NOMAX=0) are ported: on the card
    they launch kernels 1-4 and raise nothing; what still raises is a
    gradient through the forward-only `flash_attention_with_lse` and a head
    width the kernels are not built for."""
    q = torch.randn(2, 64, 32, device=cuda_device)
    counters = (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV)
    for kwargs in (dict(upcast=True), dict(no_max=False)):
        before = [c.launches for c in counters]
        qg = q.clone().requires_grad_()
        flash_attention(qg, q, q, scale=0.1, **kwargs).sum().backward()
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == [n + 1 for n in before], kwargs
        assert bool(torch.isfinite(qg.grad).all())
    monkeypatch.setenv("GMTPU_FLASH_NOMAX", "0")  # the running-max contract, read at each call
    before = FLASH_FWD.launches
    flash_attention(q, q, q, scale=0.1)
    flash_attention_with_lse(q, q, q, scale=0.1)
    flash_attention_with_lse(q, q, q, scale=0.1, upcast=True)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 3
    monkeypatch.delenv("GMTPU_FLASH_NOMAX")
    with pytest.raises(NotImplementedError):
        flash_attention_with_lse(q.clone().requires_grad_(), q, q, scale=0.1)
    # a gradient of the default contract runs the backward kernels
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


# the JAX kernel's other two contracts: (upcast, no_max)
CONTRACTS = {"upcast": (True, True), "running_max": (False, False)}
# (BH, Sq, Sk, causal): Sk 1 and 77 are the cross-attention contexts of the
# conditioned UNets (brain covariates, CXR text) at Sq 1024
CONTRACT_SHAPES = {
    "self": (2, 512, 512, False),
    "causal": (2, 300, 300, True),
    "ragged": (3, 200, 333, False),
    "ctx1": (2, 1024, 1, False),
    "ctx77": (2, 1024, 77, False),
}


def _contract_inputs(device, bh, sq, sk, d, dtype, seed=7, mult=1.0):
    g = torch.Generator(device).manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=g, device=device).to(dtype) for s in (sq, sk, sk))
    return (q.float() * mult).to(dtype), k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("case", sorted(CONTRACT_SHAPES))
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_contract_forward_kernel_matches_reference_on_gpu(cuda_device, contract, case, d, dtype):
    """Kernel 1 under each contract against the plain version: O at the
    forward tolerance, the lse at it relative to max(1, max|lse|) (the lse
    holds the row's largest score, and the kernel sums and rescales l tile
    by tile, the plain version once). Unit inputs, as phase 2 of
    chip_smoke.py: the f32 O tolerance of 1e-5 holds for scores of order
    one, since the exp turns each score's f32 rounding, ~1e-7 of |s|, into
    that share of p (at q x 4, natural logits up to ~25, f32 O differs by
    up to 2.4e-5 at D = 128 and 256)."""
    upcast, no_max = CONTRACTS[contract]
    bh, sq, sk, causal = CONTRACT_SHAPES[case]
    q, k, v = _contract_inputs(cuda_device, bh, sq, sk, d, dtype)
    kw = dict(scale=d**-0.5, causal=causal, upcast=upcast, no_max=no_max)
    before = FLASH_FWD.launches
    o, lse = FLASH_FWD(q, k, v, **kw)
    ref_o, ref_lse = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    assert o.dtype == dtype and bool(torch.isfinite(o.float()).all())
    o_tol, lse_tol = FWD_TOL[dtype]
    assert (o.float() - ref_o.float()).abs().max().item() <= o_tol
    lse_scale = max(1.0, ref_lse.abs().max().item())
    assert (lse - ref_lse).abs().max().item() <= lse_tol * lse_scale


def _contract_backward_inputs(device, bh, sq, sk, d, dtype, causal, upcast, no_max, seed=8):
    """The backward's inputs as the `flash_fwd` op's gradient hands them on: q
    prescaled and the log2 lse under the exp2 contracts; q as it is and the
    natural lse under upcast."""
    q, k, v = _contract_inputs(device, bh, sq, sk, d, dtype, seed=seed, mult=4.0)
    dout = torch.randn((bh, sq, d), generator=torch.Generator(device).manual_seed(seed + 1),
                       device=device).to(dtype)
    kw = dict(causal=causal, upcast=upcast, no_max=no_max)
    out, lse = FLASH_FWD(q, k, v, scale=d**-0.5, log2_lse=not upcast, **kw)
    q_in = q if upcast else _prescaled(q, d**-0.5)
    return (q_in, k, v, out, lse, dout), dict(scale=d**-0.5, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("case", ["causal", "ragged", "ctx1", "ctx77"])
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_contract_backward_kernels_match_reference_on_gpu(cuda_device, monkeypatch, contract,
                                                          case, d, dtype):
    """Kernels 2 + 3 and kernel 4 under each contract against the plain
    backward, relative to the largest gradient at BWD_TOL; kernel 4's dk
    and dv against kernel 3's as in the default contract (to the bit where
    they share a body). At
    Sk = 1 each row's softmax is 1 and ds = p (dp - delta) cancels to
    rounding, so dq and dk are 0 in exact arithmetic: they are held to the
    size of the cancelling terms (max|dO| max|v| max|k|, or max|q| for dk,
    in row norms, times the scale under upcast) instead of their own."""
    upcast, no_max = CONTRACTS[contract]
    bh, sq, sk, causal = CONTRACT_SHAPES[case]
    args, kw = _contract_backward_inputs(cuda_device, bh, sq, sk, d, dtype, causal, upcast,
                                         no_max)
    counters = (FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_FUSED)
    before = [c.launches for c in counters]
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "0")
    split = flash_attention_backward(*args, **kw)
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    fused = flash_attention_backward(*args, **kw)
    want = flash_attention_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 1 for n in before]
    sizes = _gradient_sizes(args, kw, want)
    for got in (split, fused):
        for a, b, size in zip(got, want, sizes):
            assert a.dtype == dtype and a.shape == b.shape
            assert bool(torch.isfinite(a.float()).all())
            assert (a.float() - b.float()).abs().max().item() <= BWD_TOL[dtype] * size
    _assert_fused_dkv_agree(fused, split, dtype, d, upcast, sizes)


def _gradient_sizes(args, kw, want) -> list[float]:
    """The size each gradient's error is held to: its largest value, and at
    Sk = 1 for dq and dk the size of the terms that cancel in them."""
    sizes = [b.float().abs().max().item() for b in want]
    q_in, k, v, _, _, dout = args
    if k.shape[1] == 1:

        def rows(t):
            return t.float().norm(dim=-1).max().item()

        terms = rows(dout) * rows(v) * (kw["scale"] if kw["upcast"] else 1.0)
        sizes[0] = max(sizes[0], terms * rows(k))
        sizes[1] = max(sizes[1], terms * rows(q_in))
    return sizes


# the wgmma route of kernels 2 and 3 (bf16 at D = 64): (BH, Sq, Sk, causal);
# Sq and Sk no multiples of its 64-row tiles or 128-row blocks, the
# cross-attention contexts Sk = 1 and 77, and Sq below and above Sk (the
# sequence-parallel allgather's local rows against every key)
WGMMA_SHAPES = {
    "causal": (3, 257, 257, True),
    "ragged": (2, 200, 333, False),
    "ctx1": (4, 1024, 1, False),
    "ctx77": (4, 1000, 77, False),
    "sq_below_sk": (2, 512, 2048, False),
    "sq_above_sk_causal": (2, 700, 300, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_SHAPES))
@pytest.mark.parametrize("contract", ["no_max", "running_max"])
def test_wgmma_route_backward_kernels_on_gpu(cuda_device, contract, case):
    """Kernels 2, 3 and 4 on the wgmma route against the plain backward at
    BWD_TOL (relative to `_gradient_sizes`), in both exp2 contracts; two
    launches of each give the same bits (kernels 2 and 3: no atomics, a dq
    row belongs to one warpgroup, a dk, dv row to one; kernel 4: its key
    blocks add their dq parts in key-block order); kernel 4's dk, dv equal
    kernel 3's to the bit and its dq is within the fused margin of kernel
    2's."""
    bh, sq, sk, causal = WGMMA_SHAPES[case]
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"):
        assert attention_route(torch.bfloat16, 64, kernel=kernel) == ROUTE_WGMMA
    args, kw = _contract_backward_inputs(cuda_device, bh, sq, sk, 64, torch.bfloat16, causal,
                                         False, contract == "no_max")
    q_in, k, v, out, lse2, dout = args
    do2, delta = _backward_rows(out, dout)
    bkw = dict(causal=causal, no_max=kw["no_max"])
    counters = (FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_FUSED)
    before = [c.launches for c in counters]
    first = (FLASH_BWD_DQ(q_in, k, v, do2, lse2, delta, **bkw),
             *FLASH_BWD_DKV(q_in, k, v, do2, lse2, delta, **bkw))
    again = (FLASH_BWD_DQ(q_in, k, v, do2, lse2, delta, **bkw),
             *FLASH_BWD_DKV(q_in, k, v, do2, lse2, delta, **bkw))
    fused = FLASH_BWD_FUSED(q_in, k, v, do2, lse2, delta, **bkw)
    fused_again = FLASH_BWD_FUSED(q_in, k, v, do2, lse2, delta, **bkw)
    want = flash_attention_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 2 for n in before]
    sizes = _gradient_sizes(args, kw, want)
    for got, repeat in ((first, again), (fused, fused_again)):
        for a, a2, b, size in zip(got, repeat, want, sizes):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            assert bool(torch.isfinite(a.float()).all())
            assert (a.float() - b.float()).abs().max().item() <= BWD_TOL[torch.bfloat16] * size
            assert torch.equal(a.view(torch.int16), a2.view(torch.int16))
    _assert_fused_dkv_agree(fused, first, torch.bfloat16, 64)
    _assert_within_fused_margin(fused[0], first[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_SHAPES))
@pytest.mark.parametrize("contract", ["no_max", "running_max"])
def test_wide_route_backward_kernels_on_gpu(cuda_device, contract, case):
    """Kernels 2, 3 and 4 on their D = 256 wgmma bodies (bf16 at head width
    256, both exp2 contracts), at the wgmma route's shapes (Sq and Sk no
    multiples of kernel 2's 32-key tiles and 128-row blocks or kernels 3
    and 4's 64-row q tiles and 64-key blocks): against the plain backward
    at BWD_TOL (relative to `_gradient_sizes`), two launches equal to the
    bit (no atomics; a dq row belongs to one warpgroup, a dk, dv element to
    one; kernel 4 adds its dq parts in key-block order); kernel 4's dk, dv
    equal kernel 3's to the bit and its dq is within the fused margin of
    kernel 2's."""
    bh, sq, sk, causal = WGMMA_SHAPES[case]
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attention_route(torch.bfloat16, 256, kernel=kernel) == ROUTE_WGMMA
    assert attention_route(torch.bfloat16, 256, kernel="flash_bwd_fused") == ROUTE_WGMMA
    args, kw = _contract_backward_inputs(cuda_device, bh, sq, sk, 256, torch.bfloat16, causal,
                                         False, contract == "no_max")
    q_in, k, v, out, lse2, dout = args
    do2, delta = _backward_rows(out, dout)
    bkw = dict(causal=causal, no_max=kw["no_max"])
    counters = (FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_FUSED)
    before = [c.launches for c in counters]
    first = (FLASH_BWD_DQ(q_in, k, v, do2, lse2, delta, **bkw),
             *FLASH_BWD_DKV(q_in, k, v, do2, lse2, delta, **bkw))
    again = (FLASH_BWD_DQ(q_in, k, v, do2, lse2, delta, **bkw),
             *FLASH_BWD_DKV(q_in, k, v, do2, lse2, delta, **bkw))
    fused = FLASH_BWD_FUSED(q_in, k, v, do2, lse2, delta, **bkw)
    fused_again = FLASH_BWD_FUSED(q_in, k, v, do2, lse2, delta, **bkw)
    want = flash_attention_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 2 for n in before]
    sizes = _gradient_sizes(args, kw, want)
    for got, repeat in ((first, again), (fused, fused_again)):
        for a, a2, b, size in zip(got, repeat, want, sizes):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            assert bool(torch.isfinite(a.float()).all())
            assert (a.float() - b.float()).abs().max().item() <= BWD_TOL[torch.bfloat16] * size
            assert torch.equal(a.view(torch.int16), a2.view(torch.int16))
    _assert_fused_dkv_agree(fused, first, torch.bfloat16, 256, sizes=sizes)
    _assert_within_fused_margin(fused[0], first[0], sizes[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d, body", [(torch.bfloat16, 256, "wide"),
                                            (torch.float32, 128, "stream"),
                                            (torch.float32, 256, "stream")],
                         ids=["bf16_d256", "f32_d128", "f32_d256"])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_wide_route_runs_its_own_kernel_on_gpu(cuda_device, kernel, dtype, d, body):
    """Which kernel ran, as the profiler names it: at bf16 D = 256 the dq
    and dkv launchers launch `flash_bwd_dq_wide_kernel` and
    `flash_bwd_dkv_wide_kernel` (the D = 256 wgmma body), at f32 D = 128
    and 256 `flash_bwd_dq_stream_kernel` and `flash_bwd_dkv_stream_kernel`
    (the TF32 body streamed over D), and no mma.sync body."""
    from torch.profiler import ProfilerActivity, profile

    args, _ = _contract_backward_inputs(cuda_device, 2, 300, 300, d, dtype, False, False, True)
    q_in, k, v, out, lse2, dout = args
    do2, delta = _backward_rows(out, dout)
    launcher = FLASH_BWD_DQ if kernel == "flash_bwd_dq" else FLASH_BWD_DKV
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launcher(q_in, k, v, do2, lse2, delta)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if f"{kernel}_" in e.name and "_kernel" in e.name]
    assert names and all(f"{kernel}_{body}_kernel" in name for name in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d, body", [(torch.bfloat16, 256, "wide"),
                                            (torch.float32, 64, "tf32")],
                         ids=["bf16_d256", "f32_d64"])
def test_fused_route_runs_its_own_kernel_on_gpu(cuda_device, dtype, d, body):
    """Which kernel ran, as the profiler names it: at bf16 D = 256 the fused
    launcher launches `flash_bwd_fused_wide_kernel` (kernel 3's D = 256
    wgmma body and the dq parts), at f32 D = 64 `flash_bwd_fused_tf32_kernel`
    (kernel 3's TF32 body and the dq parts), and no mma.sync body."""
    from torch.profiler import ProfilerActivity, profile

    args, _ = _contract_backward_inputs(cuda_device, 2, 300, 300, d, dtype, False, False, True)
    q_in, k, v, out, lse2, dout = args
    do2, delta = _backward_rows(out, dout)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        FLASH_BWD_FUSED(q_in, k, v, do2, lse2, delta)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_bwd_fused_" in e.name]
    assert names and all(f"flash_bwd_fused_{body}_kernel" in name for name in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", sorted(WGMMA_SHAPES))
@pytest.mark.parametrize("contract", ["no_max", "running_max", "upcast"])
def test_tf32_route_backward_kernels_on_gpu(cuda_device, contract, case, d):
    """Kernels 2 and 3 on their TF32 wgmma bodies (f32 at D = 64; at D = 128
    and 256 the body streamed over D), in all three contracts, at the wgmma
    route's shapes in f32 (Sq and Sk no multiples of the bodies' 32-row
    tiles or 64- and 128-row blocks): against the plain backward at BWD_TOL
    (relative to `_gradient_sizes`), two launches equal to the bit (no
    atomics; a dq row belongs to one warpgroup, a dk, dv element to one);
    kernel 4 (its TF32 body at D = 64, mma.sync at 128 and 256) against the
    plain backward too, two launches equal to the bit, its dk, dv equal to
    kernel 3's at D = 64 and its dq within the fused margin of kernel 2's."""
    bh, sq, sk, causal = WGMMA_SHAPES[case]
    upcast = contract == "upcast"
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert attention_route(torch.float32, d, upcast, kernel=kernel) == ROUTE_TF32
    assert (attention_route(torch.float32, d, upcast, kernel="flash_bwd_fused")
            == (ROUTE_TF32 if d == 64 else ROUTE_MMA))
    args, kw = _contract_backward_inputs(cuda_device, bh, sq, sk, d, torch.float32, causal,
                                         upcast, contract != "running_max")
    q_in, k, v, out, lse, dout = args
    do_k, delta = _backward_rows(out, dout, upcast)
    bkw = dict(causal=causal, upcast=upcast, no_max=kw["no_max"], scale=kw["scale"])
    counters = (FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_FUSED)
    before = [c.launches for c in counters]
    first = (FLASH_BWD_DQ(q_in, k, v, do_k, lse, delta, **bkw),
             *FLASH_BWD_DKV(q_in, k, v, do_k, lse, delta, **bkw))
    again = (FLASH_BWD_DQ(q_in, k, v, do_k, lse, delta, **bkw),
             *FLASH_BWD_DKV(q_in, k, v, do_k, lse, delta, **bkw))
    fused = FLASH_BWD_FUSED(q_in, k, v, do_k, lse, delta, **bkw)
    fused_again = FLASH_BWD_FUSED(q_in, k, v, do_k, lse, delta, **bkw)
    want = flash_attention_backward_reference(*args, **kw)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + 2 for n in before]
    sizes = _gradient_sizes(args, kw, want)
    for got, repeat in ((first, again), (fused, fused_again)):
        for a, a2, b, size in zip(got, repeat, want, sizes):
            assert a.dtype == torch.float32 and a.shape == b.shape
            assert bool(torch.isfinite(a).all())
            assert (a - b).abs().max().item() <= BWD_TOL[torch.float32] * size
            assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
    _assert_fused_dkv_agree(fused, first, torch.float32, d, upcast, sizes)
    _assert_within_fused_margin(fused[0], first[0], sizes[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_SHAPES) + ["many_blocks_causal"])
@pytest.mark.parametrize("contract", ["no_max", "running_max"])
def test_wgmma_route_forward_kernel_on_gpu(cuda_device, contract, case):
    """Kernel 1 on the wgmma route against the plain version at the forward
    tolerances (the lse relative to max(1, max|lse|)), in both exp2
    contracts, at 64-row blocks (the WGMMA_SHAPES leave half of the SMs
    idle at 128 rows) and at 128-row ones (many_blocks_causal, whose rows
    also equal to the bit those of launches on two heads at a time, at
    64-row blocks); two launches give the same bits."""
    bh, sq, sk, causal = WGMMA_SHAPES.get(case, (140, 300, 300, True))
    assert attention_route(torch.bfloat16, 64, kernel="flash_fwd") == ROUTE_WGMMA
    q, k, v = _contract_inputs(cuda_device, bh, sq, sk, 64, torch.bfloat16)
    kw = dict(scale=0.125, causal=causal, no_max=contract == "no_max")
    before = FLASH_FWD.launches
    o, lse = FLASH_FWD(q, k, v, **kw)
    o2, lse2 = FLASH_FWD(q, k, v, **kw)
    ref_o, ref_lse = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 2
    assert bool(torch.isfinite(o.float()).all())
    o_tol, lse_tol = FWD_TOL[torch.bfloat16]
    assert (o.float() - ref_o.float()).abs().max().item() <= o_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol * max(1.0, ref_lse.abs().max().item())
    assert torch.equal(o.view(torch.int16), o2.view(torch.int16)) and torch.equal(lse, lse2)
    if case == "many_blocks_causal":
        for i in range(0, bh, 2):
            part, part_lse = FLASH_FWD(q[i:i + 2], k[i:i + 2], v[i:i + 2], **kw)
            assert torch.equal(part.view(torch.int16), o[i:i + 2].view(torch.int16))
            assert torch.equal(part_lse, lse[i:i + 2])



def _forward_against_reference(q, k, v, kw, dtype):
    """Two launches of kernel 1 against the plain version: O and the lse
    (relative to max(1, max|lse|)) at FWD_TOL, the two launches equal to the
    bit; returns (O, lse)."""
    before = FLASH_FWD.launches
    o, lse = FLASH_FWD(q, k, v, **kw)
    o2, lse2 = FLASH_FWD(q, k, v, **kw)
    ref_o, ref_lse = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 2
    assert o.dtype == dtype and bool(torch.isfinite(o.float()).all())
    o_tol, lse_tol = FWD_TOL[dtype]
    assert (o.float() - ref_o.float()).abs().max().item() <= o_tol
    assert (lse - ref_lse).abs().max().item() <= lse_tol * max(1.0, ref_lse.abs().max().item())
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(o.view(bits), o2.view(bits))
    assert torch.equal(lse.view(torch.int32), lse2.view(torch.int32))
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_SHAPES) + ["many_blocks_causal"])
@pytest.mark.parametrize("contract", ["no_max", "running_max"])
def test_wide_route_forward_kernel_on_gpu(cuda_device, contract, case):
    """Kernel 1 on its D = 256 wgmma body (bf16, both exp2 contracts)
    against the plain version at the forward tolerances, at 64-row blocks
    (the WGMMA_SHAPES leave half of the SMs idle at 128 rows) and 128-row
    ones (many_blocks_causal), causal, ragged, Sk = 1 and 77; its row sum is
    the f32 sum of the unrounded p, the plain version's at D % 128 == 0; two
    launches give the same bits."""
    bh, sq, sk, causal = WGMMA_SHAPES.get(case, (140, 300, 300, True))
    assert attention_route(torch.bfloat16, 256, kernel="flash_fwd") == ROUTE_WGMMA
    q, k, v = _contract_inputs(cuda_device, bh, sq, sk, 256, torch.bfloat16)
    kw = dict(scale=256**-0.5, causal=causal, no_max=contract == "no_max")
    _forward_against_reference(q, k, v, kw, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("case", sorted(WGMMA_SHAPES) + ["many_blocks_causal"])
@pytest.mark.parametrize("contract", ["no_max", "running_max", "upcast"])
def test_tf32_route_forward_kernel_on_gpu(cuda_device, contract, case, d):
    """Kernel 1 on its TF32 body (f32 at D = 128 and 256, all three
    contracts; under upcast bf16 inputs too, cast to f32 by the launcher)
    against the plain version at the forward tolerances, causal, ragged, Sk
    = 1 and 77, Sq below and above Sk: the WGMMA_SHAPES run in clusters of
    two blocks that split the keys (one 64-row block a row block would leave
    half of the SMs idle), many_blocks_causal unsplit; two launches give the
    same bits (each merge runs in a fixed order)."""
    bh, sq, sk, causal = WGMMA_SHAPES.get(case, (140, 300, 300, True))
    upcast, no_max = {"no_max": (False, True), "running_max": (False, False),
                      "upcast": (True, True)}[contract]
    assert attention_route(torch.float32, d, upcast, kernel="flash_fwd") == ROUTE_TF32
    for dtype in (torch.float32, torch.bfloat16) if upcast else (torch.float32,):
        q, k, v = _contract_inputs(cuda_device, bh, sq, sk, d, dtype)
        kw = dict(scale=d**-0.5, causal=causal, upcast=upcast, no_max=no_max)
        _forward_against_reference(q, k, v, kw, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("contract", ["no_max", "running_max", "upcast"])
def test_tf32_forward_key_split_on_gpu(cuda_device, contract, d):
    """The serving shape (4, 1024, 1024, D) in f32: 64 row blocks, so the TF32
    body runs in clusters of two blocks, each taking half of the keys, the
    second's state merged into the first's through distributed shared
    memory. Its O and lse against the same rows of an unsplit launch (the
    heads twice: 128 row blocks) within FWD_TOL (the same sums in another
    order), and against the plain version."""
    upcast, no_max = {"no_max": (False, True), "running_max": (False, False),
                      "upcast": (True, True)}[contract]
    q, k, v = _contract_inputs(cuda_device, 4, 1024, 1024, d, torch.float32)
    kw = dict(scale=d**-0.5, upcast=upcast, no_max=no_max)
    o, lse = _forward_against_reference(q, k, v, kw, torch.float32)
    o8, lse8 = FLASH_FWD(*(torch.cat([t, t]) for t in (q, k, v)), **kw)
    torch.cuda.synchronize()
    o_tol, lse_tol = FWD_TOL[torch.float32]
    assert (o8[:4] - o).abs().max().item() <= o_tol
    assert (lse8[:4] - lse).abs().max().item() <= lse_tol * max(1.0, lse.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d, body", [(torch.bfloat16, 64, "wgmma"),
                                            (torch.bfloat16, 256, "wide"),
                                            (torch.float32, 128, "stream"),
                                            (torch.float32, 256, "stream")],
                         ids=["bf16_d64", "bf16_d256", "f32_d128", "f32_d256"])
def test_forward_runs_its_own_kernel_on_gpu(cuda_device, dtype, d, body):
    """Which kernel 1 ran, as the profiler names it: `flash_fwd_wgmma_kernel`
    at bf16 D = 64, `flash_fwd_wide_kernel` at bf16 D = 256 and
    `flash_fwd_stream_kernel` at f32 D = 128 and 256, and no mma.sync body."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _contract_inputs(cuda_device, 2, 300, 300, d, dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        FLASH_FWD(q, k, v, scale=d**-0.5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_fwd_" in e.name and "_kernel" in e.name]
    assert names and all(f"flash_fwd_{body}_kernel" in name for name in names), names

# a route that no kernel takes
UNKNOWN_ROUTE = 3
ALL_FOUR = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype, route, refusing, d",
    [(torch.bfloat16, ROUTE_MMA, ALL_FOUR, 64), (torch.float32, ROUTE_WGMMA, ALL_FOUR, 64),
     (torch.bfloat16, UNKNOWN_ROUTE, ALL_FOUR, 64),
     (torch.float32, ROUTE_MMA, ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"), 64),
     (torch.float32, ROUTE_TF32, ("flash_fwd",), 64),
     (torch.bfloat16, ROUTE_TF32, ALL_FOUR, 64),
     (torch.bfloat16, ROUTE_MMA, ALL_FOUR, 256),
     (torch.float32, ROUTE_TF32, ("flash_bwd_fused",), 128),
     (torch.float32, ROUTE_WGMMA, ALL_FOUR, 256),
     (torch.float32, ROUTE_MMA, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 128),
     (torch.float32, ROUTE_MMA, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 256),
     (torch.float32, ROUTE_TF32, ("flash_bwd_fused",), 256),
     (torch.bfloat16, ROUTE_TF32, ALL_FOUR, 256),
     (torch.float32, ROUTE_WGMMA, ALL_FOUR, 128),
     (torch.bfloat16, ROUTE_WGMMA, ALL_FOUR, 128)],
    ids=["mma_at_bf16_d64", "wgmma_at_f32", "unknown", "mma_at_f32_d64",
         "tf32_in_kernel_1_at_d64", "tf32_at_bf16", "mma_at_bf16_d256",
         "tf32_in_kernel_4_at_d128", "wgmma_at_f32_d256", "mma_at_f32_d128_split",
         "mma_at_f32_d256_split", "tf32_in_kernel_4_at_d256", "tf32_at_bf16_d256",
         "wgmma_at_f32_d128", "wgmma_at_bf16_d128"])
def test_backward_route_refused_on_gpu(cuda_device, monkeypatch, dtype, route, refusing, d):
    """Each (kernel, input) of kernels 1-4 takes one body: their C entries
    refuse the mma.sync route at bf16 D = 64 and 256 (exp2 contracts), in
    kernels 1-3 at f32 D = 128 and 256 and in kernels 2-4 at f32 D = 64;
    the wgmma route at f32 and at bf16 D = 128; the TF32 route in kernel 4
    at D = 128 and 256, in kernel 1 at D = 64 and at bf16; and an unknown
    route. The launcher raises and counts no launch."""
    args, _ = _contract_backward_inputs(cuda_device, 2, 128, 128, d, dtype, False, False, True)
    q_in, k, v, out, lse2, dout = args
    do2, delta = _backward_rows(out, dout)
    # kernels 1 and 4 take the route from `attention_route`: stand the one
    # under test in for it
    monkeypatch.setattr(sys.modules[FLASH_FWD.__module__], "attention_route",
                        lambda *a, **k_: route)
    calls = {
        "flash_bwd_dq": (FLASH_BWD_DQ, lambda: FLASH_BWD_DQ._run(
            (torch.empty_like(q_in),), q_in, k, v, do2, lse2, delta, False, False, True, 1.0,
            route)),
        "flash_bwd_dkv": (FLASH_BWD_DKV, lambda: FLASH_BWD_DKV._run(
            (torch.empty_like(k), torch.empty_like(v)), q_in, k, v, do2, lse2, delta, False,
            False, True, 1.0, route)),
        "flash_fwd": (FLASH_FWD, lambda: FLASH_FWD(q_in, k, v, scale=0.125)),
        "flash_bwd_fused": (FLASH_BWD_FUSED, lambda: FLASH_BWD_FUSED(q_in, k, v, do2, lse2,
                                                                     delta)),
    }
    for name in refusing:
        kernel, call = calls[name]
        before = kernel.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            call()
        assert kernel.launches == before, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_contracts_through_flash_attention_on_gpu(cuda_device, contract, dtype):
    """`flash_attention` under each contract, forward and backward on the
    kernels, against torch's autograd through the plain version on the same
    card (exact for these contracts: no clamp), at the forward and backward
    tolerances."""
    upcast, no_max = CONTRACTS[contract]
    q, k, v = _contract_inputs(cuda_device, 2, 1024, 77, 64, dtype, seed=9, mult=4.0)
    dout = torch.randn(q.shape, generator=torch.Generator(cuda_device).manual_seed(10),
                       device=cuda_device).to(dtype)
    kw = dict(scale=0.125, upcast=upcast, no_max=no_max)
    grads = {}
    for name, fn in (("kernel", flash_attention),
                     ("plain", lambda *a, **k_: flash_attention_reference(*a, **k_)[0])):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, **kw)
        out.backward(dout)
        grads[name] = (out.detach(), *(t.grad for t in leaves))
    torch.cuda.synchronize()
    assert (grads["kernel"][0].float() - grads["plain"][0].float()).abs().max().item() <= (
        FWD_TOL[dtype][0])
    for a, b in zip(grads["kernel"][1:], grads["plain"][1:]):
        assert a.dtype == dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * b.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype, contract", [(torch.float32, "upcast"),
                                             (torch.float32, "running_max"),
                                             (torch.bfloat16, "running_max")])
def test_sdp_roles_agree_to_the_bit_under_contracts_on_gpu(cuda_device, d, dtype, contract):
    """The shared s, dp computation with each contract's p and ds: both
    operand roles give the same bits."""
    upcast, no_max = CONTRACTS[contract]
    tiles = 64
    g = torch.Generator(cuda_device).manual_seed(12)
    q, k, v, dout = (torch.randn((tiles, 16, d), generator=g, device=cuda_device).to(dtype)
                     for _ in range(4))
    scale = d**-0.5
    s_ref = torch.matmul(q.float(), k.float().transpose(1, 2))
    lse = (torch.logsumexp(s_ref * scale, dim=-1) if upcast
           else torch.logsumexp(s_ref * scale, dim=-1) * 1.4426950408889634)
    if not upcast:
        q = _prescaled(q, scale)
    delta = torch.randn((tiles, 16), generator=g, device=cuda_device)
    out = FLASH_BWD_ROLES(q, k, v, dout, lse, delta, upcast=upcast, no_max=no_max, scale=scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and out[0, 2].abs().max().item() > 0
    assert torch.equal(out[0].view(torch.int32), out[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["DDPMScheduler", "DDIMScheduler",
                                  "DPMSolverMultistepScheduler", "PNDMScheduler"])
def test_scheduler_moves_to_the_card(cuda_device, name):
    """`set_timesteps(n, device="cuda")` moves the plan and every table to
    the card, and a step there gathers from them."""
    from generativemodels_tpu_torch.networks import schedulers

    sched = getattr(schedulers, name)(num_train_timesteps=100)
    sched.set_timesteps(10, device="cuda")
    tables = [t for t in vars(sched).values() if isinstance(t, torch.Tensor)]
    assert all(t.is_cuda for t in tables) and sched.timesteps.is_cuda
    x = torch.randn(2, 1, 8, 8, device=cuda_device)
    if hasattr(sched, "init_state"):
        out, _ = sched.step(sched.init_state(x.shape), 0.1 * x, sched.timesteps[0], x)
    else:
        out, _ = sched.step(0.1 * x, sched.timesteps[0], x)
    torch.cuda.synchronize()
    assert out.is_cuda and bool(torch.isfinite(out).all())


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
        ((1, 3, 4, 72, 8, 130), torch.bfloat16, True, None, True),  # 3 Cout tiles, 16-byte copies
        ((1, 1, 8, 32, 32, 32), torch.bfloat16, True, torch.bfloat16, True),  # D = 1
        ((2, 2, 8, 32, 32, 32), torch.bfloat16, True, None, True),  # D = 2
        ((1, 6, 13, 45, 32, 32), torch.bfloat16, True, torch.bfloat16, True),  # ragged H, W
        ((1, 6, 13, 48, 32, 64), torch.bfloat16, True, torch.float32, True),  # ragged, aligned W
        ((1, 5, 8, 64, 40, 32), torch.bfloat16, True, torch.bfloat16, True),  # Cin = 40
        ((1, 5, 8, 64, 40, 32), torch.bfloat16, False, None, True),
        ((1, 4, 8, 64, 64, 64), torch.bfloat16, True, torch.bfloat16, False),  # identity prologue
        # the latent UNet's up path (concatenated skips) under the fused route
        ((1, 8, 8, 8, 512, 256), torch.bfloat16, True, torch.bfloat16, True),
        ((1, 16, 16, 16, 384, 128), torch.bfloat16, True, torch.bfloat16, True),
        ((1, 32, 32, 32, 192, 64), torch.bfloat16, True, torch.bfloat16, True),
        # the brain LDM UNet (256, 512, 768) at its 20x28x20 latent: odd
        # extents, H != W, W < 32, Cin up to 1536 on the up path
        ((1, 20, 28, 20, 256, 256), torch.bfloat16, True, torch.bfloat16, True),
        ((1, 20, 28, 20, 768, 256), torch.bfloat16, True, torch.bfloat16, True),
        ((1, 10, 14, 10, 1280, 512), torch.bfloat16, True, torch.bfloat16, True),
        ((1, 5, 7, 5, 1536, 768), torch.bfloat16, True, torch.bfloat16, True),
        ((1, 5, 7, 5, 512, 768), torch.bfloat16, True, None, True),
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
@pytest.mark.parametrize("d", [1, 2, 5, 9, 13])
@pytest.mark.parametrize("rd", CONV_RUNS)
def test_fused_conv_depth_runs_on_gpu(cuda_device, monkeypatch, rd, d):
    """Every depth run R the bf16 kernel is built for, forced past the tile
    chooser, at depths below, at and past a run's length: runs that start
    and end outside the volume, and a last run cut short; Cout 40 is a full
    and a partial tile of 32 channels."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(fused_conv_module, "conv_tiles", lambda *args: (CONV_BN, rd, None))
    x, w, scale, shift, bias, res = _conv_inputs(cuda_device, 2, d, 6, 40, 24, 40,
                                                 torch.bfloat16, True, torch.bfloat16)
    got = fused_norm_silu_conv3d(x, w, scale, shift, bias, res)
    want = fused_norm_silu_conv3d_reference(x, w, scale, shift, bias, res)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, channels_first",
    [((1, 16, 32, 64, 96, 32), True), ((1, 16, 16, 32, 64, 64), True),
     ((1, 8, 8, 32, 128, 128), True), ((2, 5, 7, 9, 40, 24), False)],
)
def test_fused_conv_is_deterministic_on_gpu(cuda_device, shape, channels_first):
    """Each output element belongs to one block and sums in a fixed order:
    two launches give the same bits."""
    x, w, scale, shift, bias, res = _conv_inputs(cuda_device, *shape, torch.bfloat16,
                                                 channels_first, torch.bfloat16)
    first = FUSED_CONV(x, w, scale, shift, bias, res)
    second = FUSED_CONV(x, w, scale, shift, bias, res)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


# (BH, Sq, Sk): Sq != Sk with a last half key tile; two heads of several
# blocks; BH odd with one (half) key tile; nine key tiles (the four-stage ring
# wraps twice, an odd count) under a last block of 64 query rows
PROBE_SHAPES = [(1, 128, 192), (2, 1024, 2048), (3, 256, 64), (3, 192, 1152)]


def _one_hot_inputs(device, bh, sq, sk, value, seed=6):
    """q row i of head h is value * e_d with d = (7 i + h) % 64; k is zero
    but for key (37 d + h) % Sk, which is e_d, for each d < 64 (distinct keys:
    37 is prime to every Sk here); v standard normal. Each query row meets
    one key, so its output is that key's v row, which is returned as well. A
    wrong descriptor, swizzle or stage reads another column or key and
    averages v rows instead."""
    rows = torch.arange(sq)
    heads = torch.arange(bh)[:, None]
    d = (7 * rows[None, :] + heads) % 64
    q = torch.zeros(bh, sq, 64)
    q.scatter_(2, d[..., None], value)
    dims = torch.arange(64)
    keys = (37 * dims[None, :] + heads) % sk
    k = torch.zeros(bh, sk, 64)
    k[heads, keys, dims[None, :]] = 1.0
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((bh, sk, 64), generator=g)
    want = v[heads, keys.gather(1, d)]
    return (*(t.to(torch.bfloat16).to(device) for t in (q, k, v)),
            want.to(torch.bfloat16).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", OVERLAP_VARIANTS)
@pytest.mark.parametrize("bh, sq, sk", PROBE_SHAPES)
def test_overlap_probe_kernel_on_gpu(cuda_device, variant, bh, sq, sk):
    q, k, v = _probe_inputs(cuda_device, bh, *nearest_shape(variant, sq, sk))
    before = FLASH_PROBE_OVERLAP.launches
    got = flash_overlap(q, k, v, scale=0.125, variant=variant)
    again = flash_overlap(q, k, v, scale=0.125, variant=variant)
    want, l = flash_overlap_reference(q, k, v, scale=0.125, variant=variant, with_l=True)
    torch.cuda.synchronize()
    assert FLASH_PROBE_OVERLAP.launches == before + 2
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    err, rows = relative_error(got, want, l if variant == "mxu_only" else None)
    assert rows > 0 and err <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", OVERLAP_VARIANTS)
@pytest.mark.parametrize("bh, sq, sk", PROBE_SHAPES)
def test_overlap_probe_kernel_one_hot(cuda_device, variant, bh, sq, sk):
    # prescaled, s is bf16(240 * bf16(0.125 log2 e)) = 43.25 at the one key
    # and 0 at the others: p = 2**43.25 against Sk - 1 ones (mxu_only: 43.25
    # against zeros), so o is that key's v row
    q, k, v, want = _one_hot_inputs(cuda_device, bh, *nearest_shape(variant, sq, sk), 240.0)
    got = flash_overlap(q, k, v, scale=0.125, variant=variant)
    torch.cuda.synchronize()
    assert relative_error(got, want)[0] <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VPU_VARIANTS))
@pytest.mark.parametrize("bh, sq, sk", PROBE_SHAPES)
def test_vpu_probe_kernel_on_gpu(cuda_device, variant, bh, sq, sk):
    prescaled, bf16_p = VPU_VARIANTS[variant]
    q, k, v = _probe_inputs(cuda_device, bh, *nearest_shape(variant, sq, sk), seed=5)
    opts = dict(scale=0.125, prescaled=prescaled, bf16_p=bf16_p)
    before = FLASH_PROBE_VPU.launches
    got = flash_vpu(q, k, v, **opts)
    again = flash_vpu(q, k, v, **opts)
    want = flash_vpu_reference(q, k, v, **opts)
    torch.cuda.synchronize()
    assert FLASH_PROBE_VPU.launches == before + 2
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert relative_error(got, want)[0] <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VPU_VARIANTS))
@pytest.mark.parametrize("bh, sq, sk", PROBE_SHAPES)
def test_vpu_probe_kernel_one_hot(cuda_device, variant, bh, sq, sk):
    # s = 240 * 0.125 = 30 at the one key, 0 at the others: after the max,
    # p = 1 against exp(-30), so o is that key's v row
    prescaled, bf16_p = VPU_VARIANTS[variant]
    q, k, v, want = _one_hot_inputs(cuda_device, bh, *nearest_shape(variant, sq, sk),
                                    240.0)
    got = flash_vpu(q, k, v, scale=0.125, prescaled=prescaled, bf16_p=bf16_p)
    torch.cuda.synchronize()
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
        flash_vpu(q, q, q, block_k=64, **opts)
    with pytest.raises(ValueError, match="multiples"):  # kernel 7's Sk: its 128-key step
        flash_vpu(q, q[:, :64].contiguous(), q[:, :64].contiguous(), **opts)
    with pytest.raises(ValueError, match="device"):
        flash_vpu(q, q.cpu(), q.cpu(), **opts)
    with pytest.raises(ValueError, match="head width"):
        flash_overlap(q[..., :32].contiguous(), q[..., :32].contiguous(),
                      q[..., :32].contiguous(), scale=0.125)


def _randomize(model, seed: int = 0) -> None:
    """Every parameter from a seed: weights at 1/sqrt(fan_in) (to_q, to_k at
    half that, as chip_smoke.py's `randomize`), norm scales near 1, biases
    small; a fresh UNet's zero output conv would make the checks empty."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                r = r / p[0].numel() ** 0.5
                if name.endswith(("to_q.weight", "to_k.weight")):
                    r = 0.5 * r
            elif name.endswith("weight"):
                r = 1.0 + 0.1 * r
            else:
                r = 0.1 * r
            p.copy_(r)


def _card_against_cpu(cuda_device, monkeypatch, build, call) -> None:
    """f32 on the card within 1e-4 of the CPU's largest output; bf16 on the
    card within twice the CPU bf16 run's distance from the CPU f32 run."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    outs = {}
    for dtype in (None, torch.bfloat16):
        model = build(dtype)
        _randomize(model)
        with torch.no_grad():
            outs[dtype, "cpu"] = call(model.eval(), torch.device("cpu"))
            before = FLASH_FWD.launches
            outs[dtype, "cuda"] = call(model.to(cuda_device), cuda_device).cpu()
        assert FLASH_FWD.launches > before  # the card's run went through kernel 1
    ref = outs[None, "cpu"]
    scale = ref.abs().max().item()
    assert scale > 1e-2
    assert (outs[None, "cuda"] - ref).abs().max().item() <= 1e-4 * scale
    own = (outs[torch.bfloat16, "cpu"] - ref).abs().max().item()
    assert (outs[torch.bfloat16, "cuda"] - outs[torch.bfloat16, "cpu"]).abs().max().item() <= (
        2 * own)


@pytest.mark.cuda
def test_autoencoderkl_on_gpu_matches_cpu(cuda_device, monkeypatch):
    """AEKL (16, 32, 32) at 32^3 with attention on level 1 (16^3 = 4096
    tokens, one 32-wide head: kernel 1 on the card) and nonlocal attention."""

    def build(dtype):
        return AutoencoderKL(
            spatial_dims=3, num_res_blocks=1, num_channels=(16, 32, 32),
            attention_levels=(False, True, False), norm_num_groups=8, dtype=dtype)

    x = torch.randn((1, 1, 32, 32, 32), generator=torch.Generator().manual_seed(1))
    _card_against_cpu(cuda_device, monkeypatch, build,
                      lambda model, device: model.reconstruct(x.to(device)))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["0", "1"], ids=["unfused", "fused"])
def test_latent_unet_on_gpu_matches_cpu(cuda_device, monkeypatch, fused):
    """The latent UNet's layout, narrowed to (32, 64, 64) with 32-wide
    heads, at 32^3 (kernel 1 at 16^3 = 4096 tokens); GMTPU_FUSED_RESBLOCK=1
    sends its ResnetBlocks through kernel 5 on the card and its plain
    version on the CPU, concatenated skips and the 8^3 level included."""
    monkeypatch.setenv("GMTPU_FUSED_RESBLOCK", fused)

    def build(dtype):
        return DiffusionModelUNet(
            spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=2,
            num_channels=(32, 64, 64), attention_levels=(False, True, True),
            num_head_channels=32, norm_num_groups=32, dtype=dtype)

    x = torch.randn((1, 3, 32, 32, 32), generator=torch.Generator().manual_seed(2))
    before = FUSED_CONV.launches
    _card_against_cpu(cuda_device, monkeypatch, build,
                      lambda model, device: model(x.to(device), torch.tensor([500], device=device)))
    assert (FUSED_CONV.launches > before) == (fused == "1")


@pytest.mark.cuda
@pytest.mark.parametrize("skip_prk", [False, True], ids=["prk", "plms_only"])
def test_pndm_steps_on_gpu_match_cpu(cuda_device, skip_prk):
    """A PNDM-10 chain with seeded model outputs, stepped on the card and on
    the CPU from the same samples."""
    g = torch.Generator().manual_seed(3)
    chains = {}
    for device in (torch.device("cpu"), cuda_device):
        scheduler = PNDMScheduler(skip_prk_steps=skip_prk, device=device)
        scheduler.set_timesteps(10)
        state = scheduler.init_state((2, 3, 8, 8, 8))
        chains[device.type] = (scheduler, state)
    sample = torch.randn((2, 3, 8, 8, 8), generator=g)
    (cpu, cpu_state), (gpu, gpu_state) = chains["cpu"], chains["cuda"]
    for i in range(len(cpu.timesteps)):
        out = torch.randn(sample.shape, generator=g)
        want, cpu_state = cpu.step(cpu_state, out, cpu.timesteps[i], sample)
        got, gpu_state = gpu.step(gpu_state, out.to(cuda_device), gpu.timesteps[i],
                                  sample.to(cuda_device))
        assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        sample = want


def _fused_bwd(monkeypatch, flag: str) -> dict:
    """GMTPU_FLASH_FUSED_BWD set to `flag`; the backward kernels each flag runs."""
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", flag)
    return {"0": (FLASH_BWD_DQ, FLASH_BWD_DKV), "1": (FLASH_BWD_FUSED,)}[flag]


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["0", "1"], ids=["split", "fused"])
@pytest.mark.parametrize("edge", [32, 16], ids=["aekl_32768", "latent_4096"])
def test_aekl_attention_block_gradients_on_gpu(cuda_device, monkeypatch, edge, flag):
    """The recipe's attention block, f32, on the kernels against the plain path."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    kernels = _fused_bwd(monkeypatch, flag)
    blocks = {}
    for use_flash in (True, False):
        torch.manual_seed(0)
        blocks[use_flash] = AttentionBlock(3, 64, norm_num_groups=16,
                                           use_flash_attention=use_flash).to(cuda_device)
    g = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((2, 64, edge, edge, edge), generator=g, device=cuda_device)
    dout = torch.randn(x.shape, generator=g, device=cuda_device)
    results = {}
    for use_flash, block in blocks.items():
        before = [FLASH_FWD.launches] + [k.launches for k in kernels]
        xi = x.clone().requires_grad_()
        out = block(xi)
        out.backward(dout)
        torch.cuda.synchronize()
        after = [FLASH_FWD.launches] + [k.launches for k in kernels]
        assert [a - b for a, b in zip(after, before)] == [int(use_flash)] * len(after)
        results[use_flash] = (out.detach(), xi.grad,
                              {n: p.grad for n, p in block.named_parameters()})
        del out, xi
    (out, dx, grads), (out_ref, dx_ref, grads_ref) = results[True], results[False]
    assert (out - out_ref).abs().max().item() <= 1e-4 * out_ref.abs().max().item()
    for name, got, want in [("x", dx, dx_ref)] + [(n, grads[n], grads_ref[n]) for n in grads]:
        if name == "to_k.bias":  # zero in exact arithmetic: softmax ignores a shared shift
            continue
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-3 * scale, name


@pytest.mark.cuda
def test_adversarial_step_on_gpu_matches_cpu(cuda_device, monkeypatch):
    """One adversarial stage-1 step (the recipe's) on the card and on the CPU."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    aekl = AutoencoderKL(spatial_dims=3, num_res_blocks=1, num_channels=(16, 32),
                         attention_levels=(False, True), norm_num_groups=8,
                         with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False)
    _randomize(aekl)
    disc = PatchDiscriminator(spatial_dims=3, num_channels=8, in_channels=1, num_layers_d=2)
    g = torch.Generator().manual_seed(2)
    x = torch.rand((2, 1, 32, 32, 32), generator=g)
    eps = torch.randn((2, 3, 16, 16, 16), generator=g)
    _, step = train_2d_ldm.make_stage1_steps(1e-2, 0.5)
    runs = {}
    for device in (torch.device("cpu"), cuda_device):
        a, d = (copy.deepcopy(m).to(device).train() for m in (aekl, disc))
        a.sampling = lambda mu, sigma, generator=None: mu + eps.to(mu.device) * sigma
        state = engines.init_adversarial_state(
            a, torch.optim.Adam(a.parameters(), lr=1e-4, eps=1e-3),
            d, torch.optim.Adam(d.parameters(), lr=1e-4, eps=1e-3))
        before = FLASH_FWD.launches
        _, out = step(state, x.to(device), x.to(device))
        assert (FLASH_FWD.launches > before) == (device.type == "cuda")
        runs[device.type] = ({k: float(v) for k, v in out.items()
                              if isinstance(v, torch.Tensor) and v.ndim == 0},
                             {**{f"g.{k}": v.cpu() for k, v in a.state_dict().items()},
                              **{f"d.{k}": v.cpu() for k, v in d.state_dict().items()}})
    (cpu_losses, cpu_state), (gpu_losses, gpu_state) = runs["cpu"], runs["cuda"]
    for key, want in cpu_losses.items():
        assert gpu_losses[key] == pytest.approx(want, rel=1e-4), key
    for key, want in cpu_state.items():
        torch.testing.assert_close(gpu_state[key], want, rtol=1e-4, atol=1e-6, msg=key)


@pytest.mark.cuda
def test_brain_sampler_defaults_to_the_card(cuda_device):
    unet = brain_ldm_sampler.brain_unet(num_channels=(8, 8), attention_levels=(False, True),
                                        num_head_channels=8, norm_num_groups=8).to(cuda_device)
    aekl = brain_ldm_sampler.brain_autoencoder(num_channels=(8, 8),
                                               attention_levels=(False, False),
                                               norm_num_groups=8).to(cuda_device)
    with torch.no_grad():
        volume = brain_ldm_sampler.sample_brain_ldm(
            unet.eval(), aekl.eval(), DDIMScheduler(num_train_timesteps=1000, clip_sample=False),
            (1, 3, 4, 4, 4), num_inference_steps=2)
    assert volume.device.type == "cuda" and volume.shape == (1, 1, 8, 8, 8)
    assert bool(torch.isfinite(volume).all())


AR_SHAPE = (8, 1024, 1024, 32)  # the recipe's stage 2 at --size 128: 4 heads of 32


@pytest.mark.cuda
@pytest.mark.parametrize("flag", ["0", "1"], ids=["split", "fused"])
def test_causal_head32_kernels_on_gpu(cuda_device, monkeypatch, flag):
    """Kernels 1-3 (or 1 and 4) in the causal contract at D = 32, f32."""
    kernels = _fused_bwd(monkeypatch, flag)
    bh, sq, sk, d = AR_SHAPE
    g = torch.Generator(cuda_device).manual_seed(7)
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device=cuda_device)
                     for s in (sq, sk, sk, sq))
    o, lse = FLASH_FWD(q, k, v, scale=d**-0.5, causal=True)
    ref_o, ref_lse = flash_attention_reference(q, k, v, scale=d**-0.5, causal=True)
    assert (o - ref_o).abs().max().item() <= FWD_TOL[torch.float32][0]
    assert (lse - ref_lse).abs().max().item() <= FWD_TOL[torch.float32][1]
    out, lse2 = FLASH_FWD(q, k, v, scale=d**-0.5, causal=True, log2_lse=True)
    qp = _prescaled(q, d**-0.5)
    before = [kern.launches for kern in kernels]
    got = flash_attention_backward(qp, k, v, out, lse2, dout, causal=True)
    want = flash_attention_backward_reference(qp, k, v, out, lse2, dout, causal=True)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in zip(kernels, before)] == [1] * len(kernels)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


@pytest.mark.cuda
def test_ar_transformer_training_on_the_kernels_on_gpu(cuda_device, monkeypatch):
    """The recipe's transformer at 1024 tokens: logits and every parameter's
    gradient on kernels 1-3 against the plain attention path."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "0")
    models = {}
    for use_flash in (None, False):
        torch.manual_seed(0)
        models[use_flash] = train_vqvae_transformer.build_models(
            128, use_flash_attention=use_flash)[1].to(cuda_device)
    tokens = torch.randint(0, 65, (2, 1024), generator=torch.Generator(cuda_device).manual_seed(1),
                           device=cuda_device)
    results = {}
    for use_flash, model in models.items():
        before = (FLASH_FWD.launches, FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches)
        logits = model(tokens)
        logits.float().logsumexp(-1).mean().backward()
        torch.cuda.synchronize()
        after = (FLASH_FWD.launches, FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches)
        assert [a - b for a, b in zip(after, before)] == [4 if use_flash is None else 0] * 3
        results[use_flash] = (logits.detach(), {n: p.grad for n, p in model.named_parameters()})
    (logits, grads), (logits_ref, grads_ref) = results[None], results[False]
    assert (logits - logits_ref).abs().max().item() <= 1e-4 * logits_ref.abs().max().item()
    for name, want in grads_ref.items():
        assert (grads[name] - want).abs().max().item() <= 1e-3 * want.abs().max().item(), name


class _TokenGrid:
    num_embeddings = 16

    def decode_samples(self, latent):
        return latent


@pytest.mark.cuda
def test_ar_greedy_sampling_paths_agree_on_gpu(cuda_device):
    torch.manual_seed(0)
    model = DecoderOnlyTransformer(num_tokens=17, max_seq_len=65, attn_layers_dim=32,
                                   attn_layers_depth=2, attn_layers_heads=2).to(cuda_device)
    with torch.no_grad():
        model.to_logits.bias[16] = -1e4  # BOS never leads
    ordering = Ordering("raster_scan", 2, (1, 8, 8))
    start = torch.tensor([[16], [3]], device=cuda_device)
    chains = [VQVAETransformerInferer().sample((8, 8), start, _TokenGrid(), model.eval(),
                                               ordering, top_k=1, use_cache=c)
              for c in (False, True)]
    assert chains[0].device.type == "cuda"
    torch.testing.assert_close(chains[0], chains[1], rtol=0, atol=0)


@pytest.mark.cuda
def test_ar_and_spade_recipes_default_to_the_card(cuda_device):
    before = FLASH_FWD.launches
    out = train_vqvae_transformer.main(["--stage1-steps", "1", "--stage2-steps", "1",
                                        "--batch", "2", "--size", "128"])
    assert out["likelihood"].device.type == "cuda" and FLASH_FWD.launches > before
    out = train_spade_vae.main(["--steps", "1", "--batch", "2", "--size", "32"])
    assert next(out["state"].net.parameters()).device.type == "cuda"
    out = train_spade_ldm.main(["--stage1-steps", "1", "--stage2-steps", "1", "--batch", "2",
                                "--size", "32"])
    assert next(out["unet"].parameters()).device.type == "cuda"


# The host data path and the metrics on the card's machine. The loader's
# order: 64 NIfTI files, 4 workers, repeated epochs, in file order and in the
# seeded shuffle order. The metrics on the card against the CPU on the same
# inputs: FID at rtol 2e-3 on (64, 2048) features (chip_smoke.py's FID_RTOL:
# rank-63 covariances, whose null-space eigenvalues are f32 rounding noise
# that each eigh resolves its own way, 6e-4 between the CPU's f32 and f64
# FIDs), MS-SSIM and SSIM at atol 1e-5, MMD at rtol 1e-5.
@pytest.mark.cuda
def test_loader_keeps_file_order_on_the_card_machine(cuda_device, tmp_path):
    from generativemodels_tpu_torch.data import file_dataset, native

    for i in range(64):
        native.write_nifti(str(tmp_path / f"v{i:03d}.nii"), np.full((4, 4, 4), i, np.float32))
    for _ in range(10):
        got = [int(a.flat[0]) for a in file_dataset(str(tmp_path), loop=False, num_workers=4)]
        assert got == list(range(64))
    stream = file_dataset(str(tmp_path), shuffle=True, seed=2, num_workers=4)
    for epoch in range(3):
        want = list(range(64))
        np.random.RandomState(2 + epoch).shuffle(want)
        assert [int(next(stream).flat[0]) for _ in range(64)] == want


@pytest.mark.cuda
def test_device_batches_land_on_the_card(cuda_device, tmp_path):
    from generativemodels_tpu_torch.data import device_batches, training_stream

    rng = np.random.default_rng(0)
    for i in range(8):
        np.save(tmp_path / f"x{i}.npy", rng.random((20, 20)).astype(np.float32))
    stream = training_stream(str(tmp_path), (16, 16), cache=True, seed=1)
    want = [next(stream) for _ in range(8)]
    batches = device_batches(str(tmp_path), (16, 16), 4, cache=True, seed=1, device=cuda_device)
    for i in range(2):
        got = next(batches)
        assert got.device.type == "cuda" and got.shape == (4, 1, 16, 16)
        torch.testing.assert_close(got.cpu(), torch.from_numpy(np.stack(want[4 * i: 4 * i + 4]))
                                   [:, None], rtol=0, atol=0)
    batches.close()


@pytest.mark.cuda
def test_metrics_on_gpu_match_cpu(cuda_device):
    from generativemodels_tpu_torch import metrics

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    mix = torch.randn(2048, 2048, generator=g) / 45
    a = torch.relu(torch.randn(64, 2048, generator=g) @ mix)
    b = torch.relu(torch.randn(64, 2048, generator=g) @ mix + 0.1)
    fid_cpu = float(metrics.FIDMetric()(a, b))
    fid_gpu = float(metrics.FIDMetric()(a.to(cuda_device), b.to(cuda_device)))
    assert abs(fid_gpu - fid_cpu) <= 2e-3 * abs(fid_cpu)
    for shape, weights in (((4, 1, 64, 64), (0.3, 0.3, 0.4)), ((2, 1, 48, 48, 48), (0.5, 0.5))):
        x = torch.rand(shape, generator=g)
        y = (x + 0.1 * torch.randn(shape, generator=g)).clamp(0, 1)
        nd = len(shape) - 2
        for metric in (metrics.SSIMMetric(nd, reduction="none"),
                       metrics.MultiScaleSSIMMetric(nd, weights=weights, reduction="none")):
            want = metric(x, y)
            got = metric(x.to(cuda_device), y.to(cuda_device))
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
        want = metrics.MMDMetric()(x, y)
        got = metrics.MMDMetric()(x.to(cuda_device), y.to(cuda_device))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_eval_recipes_default_to_the_card(cuda_device):
    from generativemodels_tpu_torch.recipes import eval_brain_ldm, eval_quality

    assert eval_quality.build_argparser().parse_args([]).device == "cuda"
    assert eval_brain_ldm.build_argparser().parse_args([]).device == "cuda"


def _op_qkv(device, dtype, sq=128, sk=96, d=64, seed=40):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(2, s, d, generator=g).to(device=device, dtype=dtype)
                 for s in (sq, sk, sk))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default_f32", "causal_bf16", "running_max_f32",
                                  "upcast_bf16"])
def test_flash_ops_pass_opcheck_on_the_card(cuda_device, case):
    """Kernels 1-4 as `gmtpu_torch` ops on CUDA tensors: schema, fake
    implementation, autograd registration and a traced run agree with the
    kernels' own outputs."""
    from generativemodels_tpu_torch.ops import flash_fwd

    kind, dtype = case.rsplit("_", 1)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    causal, upcast, no_max = kind == "causal", kind == "upcast", kind != "running_max"
    q, k, v = (t.requires_grad_() for t in _op_qkv(cuda_device, dtype))
    torch.library.opcheck(flash_fwd, (q, k, v, 0.125, causal, upcast, no_max, not upcast))
    before = FLASH_FWD.launches
    out, lse = flash_fwd(q, k, v, 0.125, causal, upcast, no_max, not upcast)
    assert FLASH_FWD.launches == before + 1 and lse.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_ops_pass_opcheck_on_the_card(cuda_device, dtype):
    from generativemodels_tpu_torch import ops

    q, k, v = _op_qkv(cuda_device, dtype)
    out, lse = ops.flash_fwd(q, k, v, 0.125, False, False, True, True)
    dout, delta = _backward_rows(out, torch.randn_like(out))
    args = (_prescaled(q, 0.125), k, v, dout.contiguous(), lse, delta, False, False, True, 1.0)
    for op, launcher in ((ops.flash_bwd_dq, FLASH_BWD_DQ), (ops.flash_bwd_dkv, FLASH_BWD_DKV),
                         (ops.flash_bwd_fused, FLASH_BWD_FUSED)):
        torch.library.opcheck(op, args)
        before = launcher.launches
        op(*args)
        assert launcher.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("channels_first", [False, True])
def test_fused_conv_op_passes_opcheck_on_the_card(cuda_device, channels_first):
    from generativemodels_tpu_torch.ops import fused_conv3d

    g = torch.Generator().manual_seed(41)
    shape = (1, 32, 8, 8, 16) if channels_first else (1, 8, 8, 16, 32)
    x = torch.randn(shape, generator=g).to(cuda_device, torch.bfloat16)
    if channels_first:
        x = x.permute(0, 2, 3, 4, 1)
    w = (torch.randn(3, 3, 3, 32, 48, generator=g) * 0.05).to(cuda_device)
    scale, shift = (torch.randn(1, 32, generator=g).to(cuda_device) for _ in range(2))
    bias = torch.randn(48, generator=g).to(cuda_device)
    res = torch.randn(1, 8, 8, 16, 48, generator=g).to(cuda_device, torch.bfloat16)
    args = [t.requires_grad_() for t in (x, w, scale, shift, bias, res)]
    torch.library.opcheck(fused_conv3d, (*args, True), atol=2e-2, rtol=2e-2)
    before = FUSED_CONV.launches
    out = fused_conv3d(*args, True)
    assert FUSED_CONV.launches == before + 1
    assert out.stride() == fused_conv_module._empty_output(x, 48).stride()


@pytest.mark.cuda
def test_exported_sampler_equals_the_in_process_one_on_the_card(cuda_device, tmp_path):
    """A small 2D sampler (its second level attends over 32x32 = 1024
    tokens: kernel 1) exported and served from its file gives the
    in-process images to the bit, with the same kernel-1 launches."""
    from generativemodels_tpu_torch.recipes import serve
    from generativemodels_tpu_torch.utils import load_exported

    sampler, _ = serve.build_sampler(size=64, channels=(32, 64), norm_groups=8, batch=2,
                                     ddim_steps=3, device=cuda_device)
    FLASH_FWD.launches = 0
    want = sampler(4)
    in_process = FLASH_FWD.launches
    serve.export_sampler(sampler, str(tmp_path / "s.pt2"))
    FLASH_FWD.launches = 0
    got = serve.ExportedSampler(load_exported(str(tmp_path / "s.pt2")))(4)
    # the down, middle and two up attention blocks attend at 32x32; 3 steps
    assert in_process == FLASH_FWD.launches == 12
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_png_family_reads_through_pil_where_the_decoder_is_missing(cuda_device, tmp_path):
    """On a machine without png.h the loader reads PNGs through PIL, with
    the native decoder's scaling, in file order."""
    from PIL import Image

    from generativemodels_tpu_torch.data import file_dataset, native

    for i in range(12):
        Image.fromarray(np.full((4, 4), 20 * i, np.uint8)).save(str(tmp_path / f"p{i:02d}.png"))
    got = [float(a[0, 0]) for a in file_dataset(str(tmp_path), loop=False)]
    assert got == [np.float32(20 * i) * (np.float32(1) / np.float32(255)) for i in range(12)]
    assert native.decoder_routes()["png"] in ("native", "PIL (png.h not found)")


# the sequence-parallel pieces (ops/sharded_attention.py) at a rank's shapes:
# (BH, S, D, dtype, n), the sequence cut in n blocks
SEQ_PARALLEL_CASES = [(2, 4096, 64, torch.bfloat16, 2), (2, 4096, 64, torch.bfloat16, 4),
                      (2, 2048, 128, torch.float32, 2),
                      # kernels 2 and 3 on their TF32 body (the cut f32 stage-1 step's)
                      (2, 4096, 64, torch.float32, 2),
                      # kernel 1's wgmma body at 128-row blocks unsharded, 64-row ones local
                      (8, 4096, 64, torch.bfloat16, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,dtype,n", SEQ_PARALLEL_CASES)
def test_allgather_local_kernels_equal_the_unsharded_rows(cuda_device, bh, s, d, dtype, n):
    """Kernel 1 at Sq = S/n, Sk = S (the allgather's local call) gives the
    unsharded kernel's rows to the bit, as does kernel 2's dq; kernel 3's dk,
    dv over the n query blocks sum to the unsharded ones (the gather's
    backward reduce-scatters them) within the backward tolerance."""
    g = torch.Generator("cuda").manual_seed(n)
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device="cuda").to(dtype)
                     for _ in range(4))
    scale = d**-0.5
    out, lse2 = FLASH_FWD(q, k, v, scale=scale, log2_lse=True)
    qp = _prescaled(q, scale)
    do2, delta = _backward_rows(out, dout)
    dq = FLASH_BWD_DQ(qp, k, v, do2, lse2, delta)
    dk, dv = FLASH_BWD_DKV(qp, k, v, do2, lse2, delta)
    c = s // n
    dk_sum = torch.zeros_like(dk, dtype=torch.float32)
    dv_sum = torch.zeros_like(dv, dtype=torch.float32)
    for r in range(n):
        sl = slice(r * c, (r + 1) * c)

        def rows(x):
            return x[:, sl].contiguous()

        local_out, _ = FLASH_FWD(rows(q), k, v, scale=scale)
        assert torch.equal(local_out, out[:, sl])
        assert torch.equal(FLASH_BWD_DQ(rows(qp), k, v, rows(do2), rows(lse2), rows(delta)),
                           dq[:, sl])
        dk_r, dv_r = FLASH_BWD_DKV(rows(qp), k, v, rows(do2), rows(lse2), rows(delta))
        dk_sum += dk_r.float()
        dv_sum += dv_r.float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((dk_sum, dk), (dv_sum, dv)):
        assert float((got - want.float()).abs().max() / want.float().abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,d,dtype,n", SEQ_PARALLEL_CASES)
def test_ring_merge_of_kernel_chunks_on_gpu(cuda_device, bh, s, d, dtype, n):
    """The ring's n chunks of kernel 1 with its lse, merged by
    `_combine_chunks` on the card, give the unsharded kernel's O: within
    1e-5 in f32, within 2e-2 of the largest |O| in bf16 (each chunk's O is
    rounded to bf16 before the f32 merge: a few ulps at the largest |O|)."""
    from generativemodels_tpu_torch.ops.sharded_attention import _combine_chunks

    g = torch.Generator("cuda").manual_seed(10 + n)
    q, k, v = (torch.randn((bh, s, d), generator=g, device="cuda").to(dtype) for _ in range(3))
    scale = d**-0.5
    full, _ = FLASH_FWD(q, k, v, scale=scale)
    c = s // n
    for r in range(n):
        qr = q[:, r * c:(r + 1) * c].contiguous()
        acc = acc_lse = None
        for j in (r, *[(r - i - 1) % n for i in range(n - 1)]):  # the ring's order
            o, lse = flash_attention_with_lse(qr, k[:, j * c:(j + 1) * c].contiguous(),
                                              v[:, j * c:(j + 1) * c].contiguous(), scale=scale)
            assert o.is_cuda and lse.dtype == torch.float32
            acc, acc_lse = (o.float(), lse) if acc is None else _combine_chunks(acc, acc_lse, o,
                                                                                 lse)
        want = full[:, r * c:(r + 1) * c].float()
        err = float((acc - want).abs().max())
        assert err <= (1e-5 if dtype == torch.float32 else 2e-2 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_fused_conv_halo_slabs_equal_the_unsharded_output(cuda_device, n):
    """Kernel 5 on each slab of a cut volume extended by one plane from
    each neighbour (none at the outer border), cropped to the slab, as the
    cut fused ResnetBlock calls it: the crops equal the unsharded output to
    the bit, in both types, with and without the residual."""
    g = torch.Generator("cuda").manual_seed(20 + n)
    b, cin, cout, d, h, w = 1, 32, 32, 32, 32, 32
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((b, cin, d, h, w), generator=g, device="cuda").to(dtype)
        res = torch.randn((b, cout, d, h, w), generator=g, device="cuda").to(dtype)
        kernel = ((27 * cin) ** -0.5 * torch.randn((3, 3, 3, cin, cout), generator=g,
                                                   device="cuda")).to(dtype)
        scale = 1.0 + 0.1 * torch.randn((b, cin), generator=g, device="cuda")
        shift = 0.1 * torch.randn((b, cin), generator=g, device="cuda")
        bias = 0.1 * torch.randn(cout, generator=g, device="cuda")
        for residual in (None, res):
            full = FUSED_CONV(x.permute(0, 2, 3, 4, 1), kernel, scale, shift, bias,
                              None if residual is None else residual.permute(0, 2, 3, 4, 1))
            c = d // n
            for r in range(n):
                lo, hi = max(0, r * c - 1), min(d, (r + 1) * c + 1)
                slab = x[:, :, lo:hi].contiguous()
                res_slab = (None if residual is None
                            else residual[:, :, lo:hi].contiguous().permute(0, 2, 3, 4, 1))
                got = FUSED_CONV(slab.permute(0, 2, 3, 4, 1), kernel, scale, shift, bias, res_slab)
                start = r * c - lo
                assert torch.equal(got[:, start:start + c], full[:, r * c:(r + 1) * c])
