"""Flash-attention forward over (BH, S, D): a CUDA kernel and its plain version.

Counterpart of generativemodels_tpu/ops/flash_attention.py (forward only).
The Pallas TPU kernel `_fwd_kernel` becomes `csrc/flash_fwd.cu`, a kernel
written for Hopper; the source's header says what bounds it and how it is
laid out. `flash_attention_reference` is plain PyTorch code for the same
function and contract: the CPU path, and what the kernel is held against.

The contract is the JAX default (exp2 domain, `no_max`): q is prescaled by
scale*log2(e) in q's type, scores are clamped at 80 with no running max,
p = exp2(s), O = (p V) / max(sum p, 1e-30), and the lse is the natural-log
row logsumexp. Matmul operands stay in the input type (bf16 or f32), with
f32 accumulation; for bf16, p is rounded to bf16 before the PV product.

A wrapper takes the plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernel or raises; `upcast=True`, `no_max=False` and
gradients are not ported to the kernel yet and raise NotImplementedError.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .native import load_library

LOG2E = 1.4426950408889634  # log2(e)
LN2 = 0.6931471805599453  # 1/LOG2E
HEAD_DIMS = (32, 64, 128, 256)  # head widths the kernel is instantiated for
_BLOCK_Q = 32  # query rows per block (kBlockQ in csrc/flash_fwd.cu)
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention with the kernel's contract.

    Args:
        q: (BH, Sq, D); k, v: (BH, Sk, D), f32 or bf16.
        scale: softmax temperature (typically 1/sqrt(D)).
        causal: mask keys past the query index (col <= row attends).
        upcast: f32 operands and a natural-log softmax with a running max
            (the JAX `upcast` contract).
        no_max: the clamped, max-free softmax (the default contract).

    Returns:
        O (BH, Sq, D) in q's type and lse (BH, Sq) f32, natural log.
    """
    sq, sk = q.shape[1], k.shape[1]
    exp2 = not upcast
    no_max = no_max and exp2
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
        lse = (torch.log2(l_safe) + m) * LN2
    else:
        lse = torch.log(l_safe) + m
    return out, lse[..., 0]


class FlashForwardKernel:
    """Launcher of `csrc/flash_fwd.cu`: builds it at first use, counts launches.

    `launches` counts the kernel launches made through this object and
    nothing else, so a run can show that its attention went through the
    kernel.
    """

    source = "flash_fwd.cu"

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _function(self):
        with self._lock:
            if self._fn is None:
                fn = load_library(self.source).gm_flash_fwd
                fn.argtypes = (
                    [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                )
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def __call__(
        self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, causal: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Launch on the current stream; returns (O, lse) as the reference does."""
        _check_kernel_inputs(q, k, v)
        bh, sq, d = q.shape
        sk = k.shape[1]
        o = torch.empty_like(q)
        lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
        if o.numel() == 0:
            return o, lse
        qscale = float(torch.tensor(scale * LOG2E, dtype=q.dtype))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = self._function()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, sq, sk, d, _DTYPE_CODES[q.dtype], int(causal), qscale, q.device.index, stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
        self.launches += 1
        return o, lse


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
    if q.shape[0] * -(-q.shape[1] // _BLOCK_Q) >= 2**31:
        raise ValueError("too many query blocks for the kernel's 32-bit grid")


FLASH_FWD = FlashForwardKernel()


def _forward(q, k, v, scale, causal, upcast, no_max):
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, scale=scale, causal=causal, upcast=upcast, no_max=no_max
        )
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, not {q.device}")
    if upcast or not no_max:
        raise NotImplementedError(
            "the CUDA kernel implements the default contract only (upcast=False, no_max=True)"
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("the flash-attention backward kernels are not ported yet")
    return FLASH_FWD(q, k, v, scale=scale, causal=causal)


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
    """Attention over (BH, S, D) tensors; returns (BH, Sq, D) in q's type."""
    return _forward(q, k, v, scale, causal, upcast, no_max)[0]


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    upcast: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-only attention returning (O, lse), lse (BH, Sq) f32 natural log."""
    return _forward(q, k, v, scale, False, upcast, True)
