"""Multi-head attention dispatcher: plain matmul/softmax path or flash kernel.

Counterpart of generativemodels_tpu/ops/attention.py. The dispatch rule is
the JAX one with "on TPU" read as "q lies on a CUDA device"; its thresholds
were set on a TPU and are to be measured again on the H100. Under
`sequence_sharding` a self-attention call goes through
`ops/sharded_attention.py`, as in JAX.
"""
from __future__ import annotations

import torch

from .flash_attention import HEAD_DIMS, flash_attention

# sequence length from which auto-dispatch takes the flash kernel
_FLASH_MIN_SEQ = 1024


def resolve_use_flash(
    seq: int,
    head_dim: int,
    use_flash: bool | None = None,
    on_cuda: bool = False,
    has_mask: bool = False,
) -> bool:
    """The flash/plain dispatch decision, exposed for tests and docs.

    Masked calls (KV-cache decoding) always take the plain path, as in JAX;
    an explicit `use_flash` wins otherwise; auto-dispatch requires a CUDA tensor,
    seq >= _FLASH_MIN_SEQ and a head width the kernel is built for. The
    JAX rule admits every width up to 256; the kernel is instantiated for
    32, 64, 128 and 256 only, so a width such as 48 stays on the plain
    path here.
    """
    if has_mask:
        return False
    if use_flash is not None:
        return use_flash
    return on_cuda and seq >= _FLASH_MIN_SEQ and head_dim in HEAD_DIMS


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    *,
    scale: float | None = None,
    causal: bool = False,
    upcast: bool = False,
    use_flash: bool | None = None,
    mask: torch.Tensor | None = None,
    seq_shard: bool | None = None,
) -> torch.Tensor:
    """Multi-head attention over packed (B, S, H*D) tensors.

    Args:
        q: (B, Sq, inner_dim); k, v: (B, Sk, inner_dim).
        num_heads: number of attention heads H (inner_dim = H * D).
        scale: softmax scale; defaults to 1/sqrt(D).
        causal: lower-triangular mask.
        upcast: f32 operands for the score matmul (reference
            `upcast_attention`).
        use_flash: True forces the flash kernel (its plain version on the
            CPU), False forces the plain path, None auto-selects.
        mask: optional boolean key mask that broadcasts to (B, Sq, Sk), True
            where a query attends. Forces the plain path (KV-cache
            decoding); masked scores are filled with the type's lowest value
            after the causal mask, as in JAX.
        seq_shard: None consults the active `sequence_sharding` context
            (ops/sharded_attention.py) and routes a self-attention call (Sq ==
            Sk of this rank's blocks, no mask) through
            `sequence_parallel_attention`; False keeps the call local (a
            cross-attention context, and the sharded path's own calls).

    Returns:
        (B, Sq, inner_dim) in q's type.
    """
    b, sq, inner = q.shape
    sk = k.shape[1]
    head_dim = inner // num_heads
    if scale is None:
        scale = 1.0 / (head_dim**0.5)

    if seq_shard is not False and mask is None and sq == sk:
        from .sharded_attention import current_sequence_sharding, sequence_parallel_attention

        cfg = current_sequence_sharding()
        if cfg is not None:
            return sequence_parallel_attention(q, k, v, num_heads, cfg, scale=scale,
                                               upcast=upcast, use_flash=use_flash, causal=causal)

    use_flash = resolve_use_flash(sq, head_dim, use_flash, on_cuda=q.is_cuda,
                                  has_mask=mask is not None)

    # (B, S, H*D) -> (B, H, S, D)
    qh = q.reshape(b, sq, num_heads, head_dim).transpose(1, 2)
    kh = k.reshape(b, sk, num_heads, head_dim).transpose(1, 2)
    vh = v.reshape(b, sk, num_heads, head_dim).transpose(1, 2)

    if use_flash:
        def flat(x, s):
            return x.reshape(b * num_heads, s, head_dim).contiguous()

        out = flash_attention(
            flat(qh, sq), flat(kh, sk), flat(vh, sk), scale=scale, causal=causal, upcast=upcast
        )
        return out.reshape(b, num_heads, sq, head_dim).transpose(1, 2).reshape(b, sq, inner)

    dtype = q.dtype
    if upcast:
        qh = qh.float()
        kh = kh.float()
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if causal:
        causal_mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal_mask, torch.finfo(scores.dtype).min)
    if mask is not None:
        keep = torch.broadcast_to(mask.to(device=q.device, dtype=torch.bool), (b, sq, sk))
        scores = scores.masked_fill(~keep[:, None], torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    out = torch.matmul(probs, vh.to(dtype))
    return out.transpose(1, 2).reshape(b, sq, inner)
