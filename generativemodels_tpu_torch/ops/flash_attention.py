"""Flash attention over (BH, S, D): CUDA kernels, their plain versions, autograd.

Counterpart of generativemodels_tpu/ops/flash_attention.py. The Pallas TPU
kernels become kernels written for Hopper: the forward `_fwd_kernel` is
`csrc/flash_fwd.cu`, the split backward `_dq_kernel` and `_dkv_kernel` is
`csrc/flash_bwd.cu`; each source's header says what bounds it and how it is
laid out. `flash_attention_reference` and `flash_attention_backward_reference`
are plain PyTorch code for the same functions and contract: the CPU path,
and what the kernels are held against.

The contract is the JAX default (exp2 domain, `no_max`): q is prescaled by
scale*log2(e) in q's type, scores are clamped at 80 with no running max,
p = exp2(s), O = (p V) / max(sum p, 1e-30), and the lse is the natural-log
row logsumexp. Matmul operands stay in the input type (bf16 or f32), with
f32 accumulation; for bf16, p is rounded to bf16 before the PV product.
The backward treats the clamp as the identity, as the JAX backward does.

`flash_attention` is differentiable through `_FlashAttention`, whose
backward runs the two backward kernels (or the plain backward on the CPU).
A wrapper takes the plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernel or raises; `upcast=True` and `no_max=False`
are not ported to the kernels and raise NotImplementedError there.
"""
from __future__ import annotations

import ctypes

import torch

from .native import Launcher

LOG2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453  # 1/LOG2E
HEAD_DIMS = (32, 64, 128, 256)  # head widths the kernels are instantiated for
_BLOCK = 32  # query rows and keys per block (kBlockQ, kBlockK in csrc/)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _prescaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the constant is rounded to q's type first, as the JAX wrapper does
    return q * torch.tensor(scale * LOG2E, dtype=q.dtype)


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
        no_max: the clamped, max-free softmax (the default contract).
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
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv_dtype = torch.float32 if upcast else v.dtype
    acc = torch.matmul(p.to(pv_dtype).float(), v.to(pv_dtype).float())
    out = (acc / l_safe).to(q.dtype)
    if exp2:
        lse = torch.log2(l_safe) + m
        if not log2_lse:
            lse = lse * LN2
    else:
        lse = torch.log(l_safe) + m
    return out, lse[..., 0]


def _backward_rows(out: torch.Tensor, dout: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inputs of the backward that JAX computes in XLA outside its
    kernels: dO * ln2 in dO's type (ds then carries the d(softmax)/d(log2
    score) factor) and delta = rowsum(dO ln2 * O) in f32."""
    dout = dout * torch.tensor(LN2, dtype=dout.dtype)
    return dout, (dout.float() * out.float()).sum(dim=-1)


def flash_attention_backward_reference(
    q_prescaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse2: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the default contract, formula by formula
    the JAX split backward (`_flash_bwd` with `_dq_kernel` and `_dkv_kernel`).

    Args:
        q_prescaled: (BH, Sq, D), q already multiplied by the rounded
            scale*log2(e); k, v: (BH, Sk, D); all f32 or all bf16.
        out: the forward's O (BH, Sq, D); lse2: its (BH, Sq) f32 lse in the
            log2 domain (`log2_lse=True`); dout: the cotangent of O, in O's
            type.
        causal: the forward's causal mask.

    Returns:
        (dq_prescaled, dk, dv) in the input type; dq is the gradient with
        respect to the prescaled q (the caller applies the prescale's chain
        rule).
    """
    dtype = q_prescaled.dtype
    dout, delta = _backward_rows(out, dout)
    s = torch.matmul(q_prescaled.float(), k.float().transpose(1, 2))
    # the clamp's gradient is the identity: ds below has no clamp mask
    p = torch.exp2(torch.clamp(s, max=80.0) - lse2[..., None])
    if causal:
        live = torch.ones(s.shape[1], s.shape[2], dtype=torch.bool, device=s.device).tril()
        p = torch.where(live, p, 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
    ds = (p * (dp - delta[..., None])).to(dtype).float()
    dq = torch.matmul(ds, k.float()).to(dtype)
    dk = torch.matmul(ds.transpose(1, 2), q_prescaled.float()).to(dtype)
    dv = torch.matmul(p.to(dtype).float().transpose(1, 2), dout.float())
    return dq, dk, (dv * LOG2E).to(dtype)


class FlashForwardKernel(Launcher):
    """Launcher of `csrc/flash_fwd.cu` (replaces `_fwd_kernel`)."""

    source = "flash_fwd.cu"
    symbol = "gm_flash_fwd"
    argtypes = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_float,) * 2

    def __call__(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
        causal: bool = False, log2_lse: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Launch on the current stream; returns (O, lse) as the reference does."""
        _check_kernel_inputs(q, k, v)
        bh, sq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        if o.numel() == 0:
            return o, lse
        qscale = float(torch.tensor(scale * LOG2E, dtype=q.dtype))
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, sq, k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal), qscale,
            1.0 if log2_lse else LN2,
        )
        return o, lse


_BWD_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6


class _FlashBackwardKernel(Launcher):
    source = "flash_bwd.cu"

    def _run(self, outputs, q, k, v, dout, lse2, delta, causal: bool) -> None:
        _check_kernel_inputs(q, k, v)
        _check_backward_rows(q, dout, lse2, delta)
        if q.numel() == 0 or k.shape[1] == 0:
            for t in outputs:
                t.zero_()
            return
        bh, sq, d = q.shape
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outputs),
            bh, sq, k.shape[1], d, _DTYPE_CODES[q.dtype], int(causal),
        )


class FlashBackwardDqKernel(_FlashBackwardKernel):
    """Launcher of the dq entry point of `csrc/flash_bwd.cu` (replaces `_dq_kernel`)."""

    symbol = "gm_flash_bwd_dq"
    argtypes = _BWD_ARGTYPES[:6] + (ctypes.c_void_p,) + _BWD_ARGTYPES[6:]

    def __call__(self, q, k, v, dout, lse2, delta, *, causal: bool = False) -> torch.Tensor:
        """dq of the prescaled q from dO * ln2 and delta (`_backward_rows`) and the log2 lse."""
        dq = torch.empty_like(q)
        self._run((dq,), q, k, v, dout, lse2, delta, causal)
        return dq


class FlashBackwardDkvKernel(_FlashBackwardKernel):
    """Launcher of the dkv entry point of `csrc/flash_bwd.cu` (replaces `_dkv_kernel`)."""

    symbol = "gm_flash_bwd_dkv"
    argtypes = _BWD_ARGTYPES[:6] + (ctypes.c_void_p,) * 2 + _BWD_ARGTYPES[6:]

    def __call__(
        self, q, k, v, dout, lse2, delta, *, causal: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dk, dv) from the same inputs as the dq launcher."""
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._run((dk, dv), q, k, v, dout, lse2, delta, causal)
        return dk, dv


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


def flash_attention_backward(
    q_prescaled: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse2: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of the default contract: kernels 2 and 3 on CUDA tensors,
    `flash_attention_backward_reference` (same arguments, same results) on
    CPU tensors."""
    if q_prescaled.device.type == "cpu":
        return flash_attention_backward_reference(
            q_prescaled, k, v, out, lse2, dout, causal=causal
        )
    dout, delta = _backward_rows(out, dout)
    dq = FLASH_BWD_DQ(q_prescaled, k, v, dout, lse2, delta, causal=causal)
    dk, dv = FLASH_BWD_DKV(q_prescaled, k, v, dout, lse2, delta, causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel 1 forward (plain version on the CPU); backward by kernels 2 and
    3 (plain backward on the CPU), never by autograd through the clamp."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        # the backward reads the lse in the log2 domain, as the JAX kernel
        # keeps it: a round trip through the natural log costs ~1e-5 of p
        # where the clamp holds the log2 scores near 80
        fwd = FLASH_FWD if q.is_cuda else flash_attention_reference
        out, lse2 = fwd(q, k, v, scale=scale, causal=causal, log2_lse=True)
        ctx.save_for_backward(q, k, v, out, lse2)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse2)
        return out, lse2

    @staticmethod
    def backward(ctx, dout, _dlse2):
        q, k, v, out, lse2 = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            _prescaled(q, ctx.scale), k, v, out, lse2, dout.contiguous(), causal=ctx.causal
        )
        # JAX prescales q outside its custom VJP: the chain rule of that
        # product multiplies dq by the same rounded constant, in q's type
        return _prescaled(dq, ctx.scale), dk, dv, None, None


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
    no_max: bool = True,
) -> torch.Tensor:
    """Differentiable attention over (BH, S, D) tensors; returns (BH, Sq, D) in q's type."""
    _check_device(q)
    if upcast or not no_max:
        if q.is_cuda:
            raise NotImplementedError(
                "the CUDA kernels implement the default contract only (upcast=False, no_max=True)"
            )
        # no clamp in these contracts: autograd through the plain version is exact
        return flash_attention_reference(
            q, k, v, scale=scale, causal=causal, upcast=upcast, no_max=no_max
        )[0]
    return _FlashAttention.apply(q, k, v, scale, causal)[0]


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
    gradient raise NotImplementedError.
    """
    _check_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention_with_lse is forward-only")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale, upcast=upcast)
    if upcast:
        raise NotImplementedError("the CUDA kernel implements the default contract only")
    return FLASH_FWD(q, k, v, scale=scale)
