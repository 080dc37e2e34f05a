"""Flash attention over (BH, S, D): CUDA kernels, their plain versions, autograd.

Counterpart of generativemodels_tpu/ops/flash_attention.py. The Pallas TPU
kernels become kernels written for Hopper: the forward `_fwd_kernel` is
`csrc/flash_fwd.cu`; the split backward `_dq_kernel` and `_dkv_kernel` and
the fused backward `_dfused_kernel` are `csrc/flash_bwd.cu`; each source's
header says what bounds it and how it is laid out. Each of the four kernels
has two or three bodies there, and `attention_route` alone picks one per
launch: wgmma fed by a TMA ring for bf16 at head width 64 in the exp2
contracts (and at 256 in kernels 1-3), TF32 wgmma fed by a TMA ring for
f32 in every contract at head widths 128 and 256 (kernels 1-3) and 64
(kernels 2 and 3), mma.sync for every other case.
`flash_attention_reference` and `flash_attention_backward_reference` are
plain PyTorch code for the same functions and contract: the CPU path, and
what the kernels are held against.

The contract is the JAX default (exp2 domain, `no_max`): q is prescaled by
scale*log2(e) in q's type, scores are clamped at 80 with no running max,
p = exp2(s), O = (p V) / max(l, 1e-30), and the lse is the natural-log
row logsumexp. Matmul operands stay in the input type (bf16 or f32), with
f32 accumulation; for bf16, p is rounded to bf16 before the PV product.
The row sum l follows the JAX kernel by head width: at D % 128 != 0 it
rides the PV product on a ones column of V (`fold_l`), so it sums p
rounded to the input type; at D % 128 == 0 it sums the unrounded p (the
two agree for f32). The backward treats the clamp as the identity, as the
JAX backward does. The JAX kernel's two other contracts run on the same
kernels (`csrc/flash_contract.cuh`): GMTPU_FLASH_NOMAX=0 (read at each
call, as JAX reads it) or `no_max=False` selects the running-max online
softmax in the log2 domain, with no clamp; `upcast=True` (the reference's
`upcast_attention`) runs f32 operands, the scale applied after the
product, natural exp and a running max: the kernels' f32 route, with bf16
inputs cast to f32 once on entry and the results cast back.

Each kernel is a `torch.library` custom op in the `gmtpu_torch` namespace,
so `torch.export` records it in a graph and `torch.profiler` names it:
`flash_fwd` (O and the lse), `flash_bwd_dq`, `flash_bwd_dkv` and
`flash_bwd_fused`. Each op has a fake (shape-only) implementation, its CUDA
implementation (the launcher, which counts its launches) and a CPU
implementation (the plain version). The ops take contiguous (BH, S, D)
tensors; the callers' layout work stays outside them.
`flash_attention` is differentiable through `flash_fwd`'s registered
gradient, which runs the two split backward ops or, with
GMTPU_FLASH_FUSED_BWD=1 (read at each backward, as the JAX backward reads
it), the fused one (the plain backward on the CPU in both cases), in every
contract. On the CPU the two other contracts take the plain version with
torch's autograd through it, which is exact for them (they have no clamp).
An op takes the plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from .native import Launcher

LOG2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453  # 1/LOG2E
HEAD_DIMS = (32, 64, 128, 256)  # head widths the kernels are instantiated for
# the smallest query or key block of any flash kernel (the f32 q tiles of
# kernels 1-4, kBrF32 in csrc/flash_bwd.cu), so the grid check below holds
# for all; kernel 4's q tiles are no smaller, so one dq counter per _BLOCK
# rows covers them
_BLOCK = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the contracts of csrc/flash_contract.cuh
_NO_MAX, _RUNNING_MAX, _UPCAST = 0, 1, 2


def _contract(upcast: bool, no_max: bool) -> int:
    return _UPCAST if upcast else _NO_MAX if no_max else _RUNNING_MAX


def _prescaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the constant is rounded to q's type first, as the JAX wrapper does
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype)


@functools.lru_cache(maxsize=None)
def _qscale(scale: float, dtype: torch.dtype) -> float:
    """scale*log2(e) rounded to `dtype`: the prescale kernel 1 applies (kept,
    so that a launch builds no tensor for it)."""
    return float(torch.tensor(scale * LOG2E, dtype=dtype))


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    upcast: bool = False,
    no_max: bool = True,
    log2_lse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's contract.

    Args:
        q: (BH, Sq, D); k, v: (BH, Sk, D), f32 or bf16.
        scale: softmax temperature (typically 1/sqrt(D)).
        causal: mask keys past the query index (col <= row attends).
        upcast: f32 operands and a natural-log softmax with a running max
            (the JAX `upcast` contract).
        no_max: the clamped, max-free softmax (the default contract); its
            row sum l sums p rounded to v's type at D % 128 != 0, the
            unrounded p at D % 128 == 0, as the JAX kernel's `fold_l` does.
        log2_lse: return the lse in the log2 domain, as the JAX kernel keeps
            it for its backward (exp2 contracts only).

    Returns:
        O (BH, Sq, D) in q's type and lse (BH, Sq) f32, natural log (log2
        with `log2_lse`).
    """
    sq, sk = q.shape[1], k.shape[1]
    exp2 = not upcast
    no_max = no_max and exp2
    if log2_lse and not exp2:
        raise ValueError("log2_lse needs the exp2 contract (upcast=False)")
    if exp2:
        q = _prescaled(q, scale)
        scale = 1.0
    # bf16 products are exact in f32, so f32 matmuls of the rounded operands
    # give bf16-operand products with f32 accumulation
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if scale != 1.0:
        s = s * scale
    live = None
    if causal:
        live = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
    pv_dtype = torch.float32 if upcast else v.dtype
    if no_max:
        p = torch.exp2(torch.clamp(s, max=80.0))
        if live is not None:
            p = torch.where(live, p, 0.0)
        m = 0.0
    else:
        if live is not None:
            s = s.masked_fill(~live, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = (torch.exp2 if exp2 else torch.exp)(s - m)
    p_pv = p.to(pv_dtype).float()
    # JAX's fold_l: l rides the PV product (p in v's type) at D % 128 != 0
    l_terms = p_pv if no_max and q.shape[-1] % 128 else p
    l_safe = l_terms.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p_pv, v.to(pv_dtype).float())
    out = (acc / l_safe).to(q.dtype)
    if exp2:
        lse = torch.log2(l_safe) + m
        if not log2_lse:
            lse = lse * LN2
    else:
        lse = torch.log(l_safe) + m
    return out, lse[..., 0]


def _backward_rows(
    out: torch.Tensor, dout: torch.Tensor, upcast: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """The inputs of the backward that JAX computes in XLA outside its
    kernels: dO * ln2 in dO's type (ds then carries the d(softmax)/d(log2
    score) factor; dO as it is under `upcast`, whose softmax is natural) and
    delta = rowsum(dO * O) in f32 of that dO."""
    if not upcast:
        dout = dout * torch.tensor(LN2, dtype=dout.dtype)
    return dout, (dout.float() * out.float()).sum(dim=-1)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    scale: float = 1.0,
    upcast: bool = False,
    no_max: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of each contract, formula by formula the JAX
    split backward (`_flash_bwd` with `_dq_kernel` and `_dkv_kernel`).
    It is the plain version of the fused backward too: `_dfused_kernel`
    computes the same function (s and dp once, dq summed over the key tiles
    in f32 before the one cast), so the CPU path serves both settings of
    GMTPU_FLASH_FUSED_BWD.

    Args:
        q: (BH, Sq, D), under the exp2 contracts (`upcast=False`) already
            multiplied by the rounded scale*log2(e), under `upcast` as the
            forward took it; k, v: (BH, Sk, D); all f32 or all bf16.
        out: the forward's O (BH, Sq, D); lse: its (BH, Sq) f32 lse, in the
            log2 domain (`log2_lse=True`) under the exp2 contracts, natural
            under `upcast`; dout: the cotangent of O, in O's type.
        causal: the forward's causal mask.
        scale: the softmax scale (read under `upcast` only).
        upcast: the upcast contract: f32 products, p = exp(s * scale - lse),
            and the scale in dq and dk.
        no_max: the exp2 contract's clamp of s at 80 in p (False: the
            running-max contract, no clamp).

    Returns:
        (dq, dk, dv) in the input type. Under the exp2 contracts dq is the
        gradient with respect to the prescaled q (the caller applies the
        prescale's chain rule).
    """
    dout, delta = _backward_rows(out, dout, upcast)
    return _backward_from_rows(q, k, v, dout, lse, delta, causal, upcast, no_max, scale)


def _backward_from_rows(
    q, k, v, dout, lse, delta, causal: bool, upcast: bool, no_max: bool, scale: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_backward_reference` from dO and delta as
    `_backward_rows` gives them: the plain version of the backward kernels,
    with their arguments."""
    dtype = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if upcast:
        p = torch.exp(s * scale - lse[..., None])
    else:
        # the clamp's gradient is the identity: ds below has no clamp mask
        p = torch.exp2((torch.clamp(s, max=80.0) if no_max else s) - lse[..., None])
    if causal:
        live = torch.ones(s.shape[1], s.shape[2], dtype=torch.bool, device=s.device).tril()
        p = torch.where(live, p, 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None])
    if upcast:  # f32 operands: nothing rounds before the products
        ds = ds * scale
        dv = torch.matmul(p.transpose(1, 2), dout.float())
    else:
        ds = ds.to(dtype).float()
        dv = torch.matmul(p.to(dtype).float().transpose(1, 2), dout.float()) * LOG2E
    dq = torch.matmul(ds, k.float()).to(dtype)
    dk = torch.matmul(ds.transpose(1, 2), q.float()).to(dtype)
    return dq, dk, dv.to(dtype)


class FlashForwardKernel(Launcher):
    """Launcher of `csrc/flash_fwd.cu` (replaces `_fwd_kernel`)."""

    source = "flash_fwd.cu"
    symbol = "gm_flash_fwd"
    argtypes = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 7 + (ctypes.c_float,) * 3
                + (ctypes.c_int,))

    def __call__(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
        causal: bool = False, upcast: bool = False, no_max: bool = True,
        log2_lse: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Launch on the current stream; returns (O, lse) as the reference
        does, in each contract. Under `upcast` bf16 inputs are cast to f32
        here, the f32 kernel runs, and O is cast back to q's type."""
        if upcast and log2_lse:
            raise ValueError("log2_lse needs the exp2 contract (upcast=False)")
        dtype = q.dtype
        if upcast:
            q, k, v = q.float(), k.float(), v.float()
        _check_kernel_inputs(q, k, v)
        bh, sq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        if o.numel() == 0:
            return o.to(dtype), lse
        # the exp2 contracts prescale q by the constant rounded to q's type,
        # as the JAX wrapper does; upcast scales s after the product
        qscale = 1.0 if upcast else _qscale(scale, q.dtype)
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, sq, k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal),
            _contract(upcast, no_max), qscale, 1.0 if log2_lse else LN2, scale if upcast else 1.0,
            attention_route(q.dtype, d, upcast, kernel="flash_fwd"),
        )
        return o.to(dtype), lse


_BWD_ARGTYPES = (
    (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_float,)
)
# the backward launchers' contract keywords: `upcast` (f32 inputs, q
# unscaled, dO without ln2, the natural lse, and `scale`) or the exp2
# contracts with (`no_max`) or without the clamp

# the bodies of kernels 1-4 (`Route` in csrc/flash_fwd.cu and
# csrc/flash_bwd.cu), each (kernel, input) taking one: the bf16 wgmma ones
# fed by a TMA ring, the TF32 wgmma ones, and the mma.sync bodies
ROUTE_MMA, ROUTE_WGMMA, ROUTE_TF32 = 0, 1, 2
# the head widths of each kernel's bf16 wgmma bodies (the exp2 contracts)
# and of its TF32 bodies (f32 operands, every contract); mma.sync elsewhere
_WGMMA_D = {"flash_fwd": (64, 256), "flash_bwd_dq": (64, 256), "flash_bwd_dkv": (64, 256),
            "flash_bwd_fused": (64,)}
_TF32_D = {"flash_fwd": (128, 256), "flash_bwd_dq": (64, 128, 256),
           "flash_bwd_dkv": (64, 128, 256), "flash_bwd_fused": ()}
# kernel 4's groups of key blocks on the wgmma route, each adding into its
# own dq buffer in its own key-block order (the 3D shape's 256 key blocks a
# head in 8 chains of 32)
FUSED_DQ_GROUPS = 8


def attention_route(dtype: torch.dtype, d: int, upcast: bool = False, *, kernel: str) -> int:
    """The body that `kernel` (the name of kernel 1, 2, 3 or 4's launcher,
    which every caller gives) runs for inputs of `dtype` at head width `d`
    under the contract `upcast` names: on bf16 operands (the exp2
    contracts) ROUTE_WGMMA at D = 64, and at D = 256 in kernels 1-3; on f32
    operands (f32 inputs, or any inputs under upcast, which runs f32)
    ROUTE_TF32 at D = 128 and 256 in kernels 1-3, and at D = 64 in kernels
    2 and 3; ROUTE_MMA for everything else (kernel 4 but at bf16 D = 64,
    kernel 1 on f32 at D = 32 and 64, and D = 32 and bf16 D = 128 in every
    kernel). The four launchers pass it to their C entries, which raise on
    a route they do not run for the inputs they get."""
    if kernel not in _WGMMA_D:
        raise ValueError(f"no flash kernel {kernel!r}; one of {tuple(_WGMMA_D)}")
    if dtype == torch.bfloat16 and not upcast:
        return ROUTE_WGMMA if d in _WGMMA_D[kernel] else ROUTE_MMA
    return ROUTE_TF32 if d in _TF32_D[kernel] else ROUTE_MMA


class _FlashBackwardKernel(Launcher):
    source = "flash_bwd.cu"

    def _run(
        self, outputs, q, k, v, dout, lse2, delta, causal: bool, upcast: bool, no_max: bool,
        scale: float, *route: int,
    ) -> None:
        """Launch with the inputs, then the outputs, then the route of
        `attention_route` (and kernel 4's groups)."""
        _check_kernel_inputs(q, k, v)
        _check_backward_rows(q, dout, lse2, delta)
        if upcast and q.dtype != torch.float32:
            raise ValueError("the upcast contract runs f32 inputs")
        if q.numel() == 0 or k.shape[1] == 0:
            for t in outputs:
                t.zero_()
            return
        bh, sq, d = q.shape
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
            bh, sq, k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal),
            _contract(upcast, no_max), scale if upcast else 1.0, *route,
        )


class FlashBackwardDqKernel(_FlashBackwardKernel):
    """Launcher of the dq entry point of `csrc/flash_bwd.cu` (replaces `_dq_kernel`)."""

    symbol = "gm_flash_bwd_dq"
    argtypes = _BWD_ARGTYPES[:6] + (ctypes.c_void_p,) + _BWD_ARGTYPES[6:] + (ctypes.c_int,)

    def __call__(
        self, q, k, v, dout, lse2, delta, *, causal: bool = False, upcast: bool = False,
        no_max: bool = True, scale: float = 1.0,
    ) -> torch.Tensor:
        """dq from dO and delta (`_backward_rows`) and the lse, each in the
        contract's form (`flash_attention_backward_reference`'s arguments)."""
        dq = torch.empty_like(q)
        self._run((dq,), q, k, v, dout, lse2, delta, causal, upcast, no_max, scale,
                  attention_route(q.dtype, q.shape[2], upcast, kernel="flash_bwd_dq"))
        return dq


class FlashBackwardDkvKernel(_FlashBackwardKernel):
    """Launcher of the dkv entry point of `csrc/flash_bwd.cu` (replaces `_dkv_kernel`)."""

    symbol = "gm_flash_bwd_dkv"
    argtypes = _BWD_ARGTYPES[:6] + (ctypes.c_void_p,) * 2 + _BWD_ARGTYPES[6:] + (ctypes.c_int,)

    def __call__(
        self, q, k, v, dout, lse2, delta, *, causal: bool = False, upcast: bool = False,
        no_max: bool = True, scale: float = 1.0,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dk, dv) from the same inputs as the dq launcher."""
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._run((dk, dv), q, k, v, dout, lse2, delta, causal, upcast, no_max, scale,
                  attention_route(q.dtype, q.shape[2], upcast, kernel="flash_bwd_dkv"))
        return dk, dv


class FlashBackwardFusedKernel(_FlashBackwardKernel):
    """Launcher of the fused entry point of `csrc/flash_bwd.cu` (replaces
    `_dfused_kernel`)."""

    symbol = "gm_flash_bwd_fused"
    argtypes = (_BWD_ARGTYPES[:6] + (ctypes.c_void_p,) * 4 + _BWD_ARGTYPES[6:]
                + (ctypes.c_int,) * 2)

    def __call__(
        self, q, k, v, dout, lse2, delta, *, causal: bool = False, upcast: bool = False,
        no_max: bool = True, scale: float = 1.0,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(dq, dk, dv) from the same inputs as the split launchers, in one
        launch. The kernel's key blocks add their dq parts into zeroed f32
        buffers in key-block order, kept by zeroed int32 counters, one per
        (bh, q tile) (the kernel's q tiles hold at least _BLOCK rows on
        either route, so ceil(Sq / _BLOCK) counters a head are enough), in
        place of the TPU kernel's f32 partial slab per kv tile: one buffer
        on the mma.sync route, FUSED_DQ_GROUPS on the wgmma route (key
        block kb adds into buffer kb % FUSED_DQ_GROUPS, so fewer blocks wait
        on one another), summed here in one torch.sum (no atomics). dq is
        the same to the bit from run to run; it is cast once to the input
        type here."""
        route = attention_route(q.dtype, q.shape[2], upcast, kernel="flash_bwd_fused")
        groups = FUSED_DQ_GROUPS if route == ROUTE_WGMMA else 1
        dq = torch.zeros((groups, *q.shape), dtype=torch.float32, device=q.device)
        lock = torch.zeros((groups, q.shape[0], -(-q.shape[1] // _BLOCK)), dtype=torch.int32,
                           device=q.device)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._run((dq, lock, dk, dv), q, k, v, dout, lse2, delta, causal, upcast, no_max, scale,
                  route, groups)
        return (dq[0] if groups == 1 else dq.sum(0)).to(q.dtype), dk, dv


class FlashBackwardRolesKernel(Launcher):
    """Launcher of the test entry of `csrc/flash_bwd.cu`'s one s, dp
    computation (no TPU kernel; not exported by `ops`): for tiles of 16
    queries and 16 keys, s, dp and ds computed query-major, as kernel 2
    does, and key-major, as kernels 3 and 4 do. Equal to the bit, they
    show that the three kernels round every bf16 ds alike."""

    source = "flash_bwd.cu"
    symbol = "gm_flash_bwd_roles"
    argtypes = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4 + (ctypes.c_float,)

    def __call__(
        self, q, k, v, dout, lse2, delta, *, upcast: bool = False, no_max: bool = True,
        scale: float = 1.0,
    ) -> torch.Tensor:
        """q, k, v, dout (tiles, 16, D), lse2 and delta (tiles, 16) f32;
        returns f32 (2, 3, tiles, 16, 16): s, dp and ds (of the contract the
        keywords name, as the backward launchers take them) of every
        (query, key) pair of a tile, query-major ([0]) and key-major ([1])."""
        _check_kernel_inputs(q, k, v)
        _check_backward_rows(q, dout, lse2, delta)
        if q.shape[1] != 16 or k.shape[1] != 16:
            raise ValueError(f"tiles of 16 queries and 16 keys, got {tuple(q.shape)}")
        tiles, _, d = q.shape
        out = torch.empty((2, 3, tiles, 16, 16), dtype=torch.float32, device=q.device)
        if tiles:
            self._launch(
                q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse2.data_ptr(), delta.data_ptr(), out.data_ptr(), tiles, d,
                _DTYPE_CODES[q.dtype], _contract(upcast, no_max), scale if upcast else 1.0,
            )
        return out


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"q, k, v must all be float32 or all bfloat16, got {name} {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be (BH, S, D), got shape {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head width {q.shape[2]} not in {HEAD_DIMS}")
    blocks = q.shape[0] * -(-max(q.shape[1], k.shape[1]) // _BLOCK)
    if blocks >= 2**31:
        raise ValueError("too many blocks for the kernel's 32-bit grid")


def _check_backward_rows(q, dout, lse2, delta) -> None:
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must match q: got {tuple(dout.shape)} {dout.dtype} {dout.device}")
    if not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError("dout must be contiguous and 16-byte aligned")
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be (BH, Sq) float32 on q's device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


FLASH_FWD = FlashForwardKernel()
FLASH_BWD_DQ = FlashBackwardDqKernel()
FLASH_BWD_DKV = FlashBackwardDkvKernel()
FLASH_BWD_FUSED = FlashBackwardFusedKernel()
FLASH_BWD_ROLES = FlashBackwardRolesKernel()

# ---------------------------------------------------------------------------
# The kernels as torch.library custom ops
# ---------------------------------------------------------------------------

NAMESPACE = "gmtpu_torch"
_BWD_SCHEMA = (
    "(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, Tensor delta, bool causal, "
    "bool upcast, bool no_max, float scale)"
)


@torch.library.custom_op(
    f"{NAMESPACE}::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool causal, bool upcast, bool no_max, "
           "bool log2_lse) -> (Tensor, Tensor)",
)
def flash_fwd(q, k, v, scale, causal, upcast, no_max, log2_lse):
    """Kernel 1: (O, lse) of each contract, as `flash_attention_reference`
    returns them (the CPU implementation)."""
    return flash_attention_reference(q, k, v, scale=scale, causal=causal, upcast=upcast,
                                     no_max=no_max, log2_lse=log2_lse)


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, scale, causal, upcast, no_max, log2_lse):
    return FLASH_FWD(q, k, v, scale=scale, causal=causal, upcast=upcast, no_max=no_max,
                     log2_lse=log2_lse)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, scale, causal, upcast, no_max, log2_lse):
    # O in q's type (cast back under upcast), the lse f32 whatever the inputs
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::flash_bwd_dq", mutates_args=(), device_types="cpu",
                         schema=_BWD_SCHEMA + " -> Tensor")
def flash_bwd_dq(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    """Kernel 2: dq from dO and delta (`_backward_rows`) and the lse, each in
    the contract's form."""
    return _backward_from_rows(q, k, v, dout, lse, delta, causal, upcast, no_max, scale)[0]


@flash_bwd_dq.register_kernel("cuda")
def _flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    return FLASH_BWD_DQ(q, k, v, dout, lse, delta, causal=causal, upcast=upcast,
                        no_max=no_max, scale=scale)


@flash_bwd_dq.register_fake
def _flash_bwd_dq_fake(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    return torch.empty_like(q)


@torch.library.custom_op(f"{NAMESPACE}::flash_bwd_dkv", mutates_args=(), device_types="cpu",
                         schema=_BWD_SCHEMA + " -> (Tensor, Tensor)")
def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    """Kernel 3: (dk, dv) from the same inputs as `flash_bwd_dq`."""
    return _backward_from_rows(q, k, v, dout, lse, delta, causal, upcast, no_max, scale)[1:]


@flash_bwd_dkv.register_kernel("cuda")
def _flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    return FLASH_BWD_DKV(q, k, v, dout, lse, delta, causal=causal, upcast=upcast,
                         no_max=no_max, scale=scale)


@flash_bwd_dkv.register_fake
def _flash_bwd_dkv_fake(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    return torch.empty_like(k), torch.empty_like(v)


@torch.library.custom_op(f"{NAMESPACE}::flash_bwd_fused", mutates_args=(), device_types="cpu",
                         schema=_BWD_SCHEMA + " -> (Tensor, Tensor, Tensor)")
def flash_bwd_fused(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    """Kernel 4: (dq, dk, dv) in one pass, the same function as kernels 2
    and 3 (one plain version serves both)."""
    return _backward_from_rows(q, k, v, dout, lse, delta, causal, upcast, no_max, scale)


@flash_bwd_fused.register_kernel("cuda")
def _flash_bwd_fused_cuda(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    return FLASH_BWD_FUSED(q, k, v, dout, lse, delta, causal=causal, upcast=upcast,
                           no_max=no_max, scale=scale)


@flash_bwd_fused.register_fake
def _flash_bwd_fused_fake(q, k, v, dout, lse, delta, causal, upcast, no_max, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _fused_backward_enabled() -> bool:
    """GMTPU_FLASH_FUSED_BWD=1 selects the fused backward (kernel 4), read at
    each backward as `generativemodels_tpu/ops/flash_attention.py` reads it."""
    return os.environ.get("GMTPU_FLASH_FUSED_BWD", "0") == "1"


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    scale: float = 1.0,
    upcast: bool = False,
    no_max: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of each contract: the ops `flash_bwd_dq` and
    `flash_bwd_dkv`, or `flash_bwd_fused` alone when
    `_fused_backward_enabled()`; on CPU tensors each is the plain backward
    (`flash_attention_backward_reference`: same arguments, same results),
    whatever the setting. Under `upcast` bf16 inputs are cast to f32 once
    here and the gradients cast back to the input types."""
    dout, delta = _backward_rows(out, dout, upcast)
    types = q.dtype, k.dtype, v.dtype
    if upcast:
        q, k, v, dout = q.float(), k.float(), v.float(), dout.float()
    args = (q, k, v, dout, lse, delta, causal, upcast, no_max, scale)
    if _fused_backward_enabled():
        grads = flash_bwd_fused(*args)
    else:
        grads = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
    return tuple(g.to(t) for g, t in zip(grads, types))


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, scale, causal, upcast, no_max, log2_lse = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale, ctx.causal, ctx.upcast, ctx.no_max = scale, causal, upcast, no_max
    ctx.log2_lse = log2_lse


def _flash_fwd_backward(ctx, dout, _dlse):
    """By kernels 2 and 3 or kernel 4 (the plain backward on the CPU), never
    by autograd through the clamp. The lse is not differentiable; the exp2
    contracts' backward reads it in the log2 domain, as the JAX kernel
    keeps it (a round trip through the natural log costs ~1e-5 of p where
    the clamp holds the log2 scores near 80)."""
    q, k, v, out, lse = ctx.saved_tensors
    if ctx.log2_lse == ctx.upcast:
        raise NotImplementedError(
            "the gradient of flash_fwd reads the lse in its contract's domain: "
            "log2_lse=True under the exp2 contracts, False under upcast"
        )
    contract = dict(causal=ctx.causal, upcast=ctx.upcast, no_max=ctx.no_max)
    if ctx.upcast:
        grads = flash_attention_backward(
            q, k, v, out, lse, dout.contiguous(), scale=ctx.scale, **contract
        )
        return (*grads, None, None, None, None, None)
    dq, dk, dv = flash_attention_backward(
        _prescaled(q, ctx.scale), k, v, out, lse, dout.contiguous(), **contract
    )
    # JAX prescales q outside its custom VJP: the chain rule of that product
    # multiplies dq by the same rounded constant, in q's type
    return _prescaled(dq, ctx.scale), dk, dv, None, None, None, None, None


flash_fwd.register_autograd(_flash_fwd_backward, setup_context=_flash_fwd_setup)


def _no_max_default() -> bool:
    """GMTPU_FLASH_NOMAX=0 selects the running-max contract; anything else,
    or no variable, the max-free one. Read at each call, as
    `generativemodels_tpu/ops/flash_attention.py` reads it."""
    return os.environ.get("GMTPU_FLASH_NOMAX", "1") == "1"


def _check_device(q: torch.Tensor) -> None:
    if q.device.type != "cpu" and not q.is_cuda:
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, not {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    upcast: bool = False,
    no_max: bool | None = None,
) -> torch.Tensor:
    """Differentiable attention over (BH, S, D) tensors; returns (BH, Sq, D) in q's type.

    `no_max=None` reads GMTPU_FLASH_NOMAX at this call (`_no_max_default`).
    """
    _check_device(q)
    if no_max is None:
        no_max = _no_max_default()
    if not q.is_cuda and (upcast or not no_max):
        # no clamp in these contracts: autograd through the plain version is exact
        return flash_attention_reference(
            q, k, v, scale=scale, causal=causal, upcast=upcast, no_max=no_max
        )[0]
    return flash_fwd(q, k, v, scale, causal, upcast, no_max, not upcast)[0]


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    upcast: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-only attention returning (O, lse), lse (BH, Sq) f32 natural log.

    Not differentiable, as in the JAX package: inputs that require a
    gradient raise NotImplementedError. GMTPU_FLASH_NOMAX is read at each
    call, as `flash_attention` reads it.
    """
    _check_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention_with_lse is forward-only")
    return flash_fwd(q, k, v, scale, False, upcast, _no_max_default(), False)
