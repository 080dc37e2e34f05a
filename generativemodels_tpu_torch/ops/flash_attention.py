"""Flash attention over (BH, S, D): CUDA kernels, their plain versions, autograd.

Counterpart of generativemodels_tpu/ops/flash_attention.py. The Pallas TPU
kernels become kernels written for Hopper: the forward `_fwd_kernel` is
`csrc/flash_fwd.cu`; the split backward `_dq_kernel` and `_dkv_kernel` and
the fused backward `_dfused_kernel` are `csrc/flash_bwd.cu`; each source's
header says what bounds it and how it is laid out.
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
JAX backward does. GMTPU_FLASH_NOMAX=0 (read at each call, as JAX reads
it) selects the running-max contract instead.

`flash_attention` is differentiable through `_FlashAttention`, whose
backward runs the two split backward kernels or, with
GMTPU_FLASH_FUSED_BWD=1 (read at each backward, as the JAX backward reads
it), the fused one (the plain backward on the CPU in both cases).
A wrapper takes the plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernel or raises; `upcast=True` and the running-max
contract (`no_max=False` or GMTPU_FLASH_NOMAX=0) are not ported to the
kernels and raise NotImplementedError there.
"""
from __future__ import annotations

import ctypes
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
    It is the plain version of the fused backward too: `_dfused_kernel`
    computes the same function (s and dp once, dq summed over the key tiles
    in f32 before the one cast), so the CPU path serves both settings of
    GMTPU_FLASH_FUSED_BWD.

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
        """Launch with the inputs, then the outputs."""
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


class FlashBackwardFusedKernel(_FlashBackwardKernel):
    """Launcher of the fused entry point of `csrc/flash_bwd.cu` (replaces
    `_dfused_kernel`)."""

    symbol = "gm_flash_bwd_fused"
    argtypes = _BWD_ARGTYPES[:6] + (ctypes.c_void_p,) * 4 + _BWD_ARGTYPES[6:]

    def __call__(
        self, q, k, v, dout, lse2, delta, *, causal: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(dq, dk, dv) from the same inputs as the split launchers, in one
        launch. The kernel's key blocks add their dq parts into one zeroed
        f32 buffer in key-block order, kept by one zeroed int32 counter per
        (bh, q tile) (the kernel's q tiles hold at least _BLOCK rows, so
        ceil(Sq / _BLOCK) counters a head are enough), in place of the TPU
        kernel's f32 partial slab per kv tile: dq is the same to the bit
        from run to run. The buffer is cast once to the input type here."""
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lock = torch.zeros((q.shape[0], -(-q.shape[1] // _BLOCK)), dtype=torch.int32,
                           device=q.device)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._run((dq, lock, dk, dv), q, k, v, dout, lse2, delta, causal)
        return dq.to(q.dtype), dk, dv


class FlashBackwardRolesKernel(Launcher):
    """Launcher of the test entry of `csrc/flash_bwd.cu`'s one s, dp
    computation (no TPU kernel; not exported by `ops`): for tiles of 16
    queries and 16 keys, s, dp and ds computed query-major, as kernel 2
    does, and key-major, as kernels 3 and 4 do. Equal to the bit, they
    show that the three kernels round every bf16 ds alike."""

    source = "flash_bwd.cu"
    symbol = "gm_flash_bwd_roles"
    argtypes = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3

    def __call__(self, q, k, v, dout, lse2, delta) -> torch.Tensor:
        """q, k, v, dout (tiles, 16, D), lse2 and delta (tiles, 16) f32;
        returns f32 (2, 3, tiles, 16, 16): s, dp and ds of every (query,
        key) pair of a tile, query-major ([0]) and key-major ([1])."""
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
                _DTYPE_CODES[q.dtype],
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


def _fused_backward_enabled() -> bool:
    """GMTPU_FLASH_FUSED_BWD=1 selects the fused backward (kernel 4), read at
    each backward as `generativemodels_tpu/ops/flash_attention.py` reads it."""
    return os.environ.get("GMTPU_FLASH_FUSED_BWD", "0") == "1"


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
    """The backward of the default contract: on CUDA tensors kernels 2 and 3,
    or kernel 4 alone when `_fused_backward_enabled()`;
    `flash_attention_backward_reference` (same arguments, same results) on
    CPU tensors, whatever the setting."""
    if q_prescaled.device.type == "cpu":
        return flash_attention_backward_reference(
            q_prescaled, k, v, out, lse2, dout, causal=causal
        )
    dout, delta = _backward_rows(out, dout)
    if _fused_backward_enabled():
        return FLASH_BWD_FUSED(q_prescaled, k, v, dout, lse2, delta, causal=causal)
    dq = FLASH_BWD_DQ(q_prescaled, k, v, dout, lse2, delta, causal=causal)
    dk, dv = FLASH_BWD_DKV(q_prescaled, k, v, dout, lse2, delta, causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel 1 forward (plain version on the CPU); backward by kernels 2 and
    3 or kernel 4 (plain backward on the CPU), never by autograd through the
    clamp."""

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
    gradient raise NotImplementedError. GMTPU_FLASH_NOMAX is read at each
    call, as `flash_attention` reads it.
    """
    _check_device(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention_with_lse is forward-only")
    no_max = _no_max_default()
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale, upcast=upcast, no_max=no_max)
    if upcast or not no_max:
        raise NotImplementedError("the CUDA kernel implements the default contract only")
    return FLASH_FWD(q, k, v, scale=scale)
