"""Sequence-parallel attention over a mesh axis.

Counterpart of generativemodels_tpu/ops/sharded_attention.py. A 128^3
volume's attention level flattens to 32768 tokens; cut over the "space"
axis, each rank holds S/n of them. The JAX module keeps Q local inside
`shard_map` and moves K and V; here each rank is a process holding its own
(B, S/n, H*D) block of Q, K and V, and K/V move over the axis's process
group:

- "allgather" (default): one all-gather of K and V along the sequence,
  then `dot_product_attention` of the local queries against all keys: on
  the card kernel 1 forward and kernels 2-3 (or 4) backward at Sq = S/n,
  Sk = S. Differentiable: the gather's backward reduce-scatters dK and dV
  (parallel/collectives.py), as JAX transposes it.
- "ring": n-1 hops of K/V to the next rank (`ppermute`), each resident
  chunk through `flash_attention_with_lse` (kernel 1 with its lse, at
  Sq = Sk = S/n) and merged exactly by `_combine_chunks`. Forward-only on
  the kernel path, as in JAX; differentiable on the plain path.

`causal=True` masks by global position: rank r owns query rows [r*S/n,
(r+1)*S/n). The masked work takes the plain path on both impls, as in JAX
(the kernel has no row-offset input). `causal_layout="striped"` (allgather
only) re-homes half-blocks {r, 2n-1-r} to every rank, so each attends the
same number of keys. Striped with ring raises: the JAX module ignores the
layout there without a word (`sharded_attention.py:233`).

`with sequence_sharding(mesh):` routes every eligible
`ops.dot_product_attention` call (self-attention: Sq == Sk of the local
blocks, no mask, `seq_shard` not False) through `sequence_parallel_attention`.
A cross-attention context is never cut (the attention blocks pass
`seq_shard=False`), and an axis of one rank falls back to the unsharded
call.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass

import torch

from ..parallel.collectives import all_gather, ppermute

__all__ = [
    "current_sequence_sharding",
    "sequence_parallel_attention",
    "sequence_sharding",
]


@dataclass(frozen=True)
class SequenceShardingConfig:
    mesh: object
    axis: str = "space"
    impl: str = "allgather"  # or "ring"
    causal_layout: str = "blocked"  # or "striped" (zigzag, balanced)


_CTX: ContextVar[SequenceShardingConfig | None] = ContextVar(
    "gmtpu_torch_sequence_sharding", default=None
)


@contextmanager
def sequence_sharding(
    mesh,
    axis: str = "space",
    impl: str = "allgather",
    causal_layout: str = "blocked",
):
    """Route eligible attention calls through `sequence_parallel_attention`.

    A rank's rows are its own already, so there is no `batch_axis` (the JAX
    function's, which cuts the global batch over "data"). Raises ValueError
    on an unknown impl or layout, an axis the mesh lacks, and
    `causal_layout="striped"` with `impl="ring"`.
    """
    if impl not in ("allgather", "ring"):
        raise ValueError(f"impl must be 'allgather' or 'ring', got {impl!r}")
    if causal_layout not in ("blocked", "striped"):
        raise ValueError(f"causal_layout must be 'blocked' or 'striped', got {causal_layout!r}")
    if causal_layout == "striped" and impl == "ring":
        raise ValueError("causal_layout='striped' needs impl='allgather' (the ring is blocked)")
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    token = _CTX.set(SequenceShardingConfig(mesh, axis, impl, causal_layout))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_sequence_sharding() -> SequenceShardingConfig | None:
    return _CTX.get()


def _combine_chunks(acc_out, acc_lse, out, lse):
    """Merge a new chunk's (normalised out, lse) into the running pair.

    acc_out (B, Sq, H, D) f32, acc_lse and lse (B, Sq, H) natural log."""
    new_lse = torch.logaddexp(acc_lse, lse)
    w_acc = torch.exp(acc_lse - new_lse)[..., None]
    w_new = torch.exp(lse - new_lse)[..., None]
    return acc_out * w_acc + out.to(acc_out.dtype) * w_new, new_lse


def _chunk_attention_with_lse(q, k, v, num_heads, scale, upcast, use_flash, mask=None):
    """Local (out, lse) for one K/V chunk: kernel 1 with its lse on the card,
    the plain path on the CPU or under a mask.

    q: (B, Sq, H*D); k, v: (B, Sc, H*D). Returns out (B, Sq, H, D) in q's
    type and lse (B, Sq, H) f32 natural log. `mask` (bool (Sq, Sc), True =
    attend) forces the plain path; masked scores sit at the f32 minimum, so
    a fully masked chunk's lse weights it to 0 in `_combine_chunks`.
    """
    from .attention import resolve_use_flash
    from .flash_attention import flash_attention_with_lse

    b, sq, inner = q.shape
    sc = k.shape[1]
    head_dim = inner // num_heads
    if mask is None and resolve_use_flash(sq, head_dim, use_flash, on_cuda=q.is_cuda):
        def flat(x, s):
            return (x.reshape(b, s, num_heads, head_dim).transpose(1, 2)
                    .reshape(b * num_heads, s, head_dim).contiguous())

        out, lse = flash_attention_with_lse(flat(q, sq), flat(k, sc), flat(v, sc),
                                            scale=scale, upcast=upcast)
        out = out.reshape(b, num_heads, sq, head_dim).transpose(1, 2)
        return out, lse.reshape(b, num_heads, sq).transpose(1, 2)

    qh = q.reshape(b, sq, num_heads, head_dim)
    kh = k.reshape(b, sc, num_heads, head_dim)
    if upcast:
        qh, kh = qh.float(), kh.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float() * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None], torch.finfo(scores.dtype).min)
    lse = torch.logsumexp(scores, dim=-1)  # (B, H, Sq)
    probs = torch.exp(scores - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.reshape(b, sc, num_heads, head_dim))
    return out, lse.transpose(1, 2)


def _causal_chunk_mask(sq_local, sc, q_offset, k_offset, device):
    """Boolean (sq_local, sc) mask: global q row >= global k column."""
    q_idx = q_offset + torch.arange(sq_local, device=device)[:, None]
    k_idx = k_offset + torch.arange(sc, device=device)[None, :]
    return q_idx >= k_idx


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    cfg: SequenceShardingConfig,
    *,
    scale: float,
    upcast: bool = False,
    use_flash: bool | None = None,
    causal: bool = False,
) -> torch.Tensor:
    """Self-attention of this rank's block of the sequence, cut over cfg.axis.

    q, k, v: (B, S/n, H*D), this rank's rows [r*S/n, (r+1)*S/n) of the
    global sequence (r its index along cfg.axis). Returns this rank's rows
    of the global attention's output, (B, S/n, H*D) in q's type.
    """
    from .attention import dot_product_attention

    mesh = cfg.mesh
    n = mesh.axis_size(cfg.axis)
    if n == 1:
        return dot_product_attention(q, k, v, num_heads, scale=scale, upcast=upcast,
                                     use_flash=use_flash, seq_shard=False, causal=causal)
    group, r = mesh.group(cfg.axis), mesh.index(cfg.axis)
    b, sq_l, _ = q.shape
    s = sq_l * n
    dev = q.device
    striped = causal and cfg.causal_layout == "striped"
    if striped and sq_l % 2:
        raise ValueError(f"striped causal layout needs an even local sequence ({sq_l})")

    if cfg.impl == "allgather":
        kg = all_gather(k, group, dim=1)
        vg = all_gather(v, group, dim=1)
        if not causal:
            return dot_product_attention(q, kg, vg, num_heads, scale=scale, upcast=upcast,
                                         use_flash=use_flash, seq_shard=False)
        if not striped:
            mask = _causal_chunk_mask(sq_l, s, r * sq_l, 0, dev)
            out, _ = _chunk_attention_with_lse(q, kg, vg, num_heads, scale, upcast, use_flash,
                                               mask=mask)
            return out.to(q.dtype).reshape(b, sq_l, -1)

        # striped (zigzag): half-blocks H_0..H_{2n-1} of h rows; rank r
        # computes H_r and H_{2n-1-r}, whose causal work sums to a constant.
        # Q halves move there and the outputs back by ppermute; K/V stay in
        # natural order (the mask holds global positions).
        h = sq_l // 2

        def owner(j: int) -> int:  # zigzag owner of half-block j
            return j if j < n else 2 * n - 1 - j

        perm_lo = [(src, owner(2 * src)) for src in range(n)]
        perm_hi = [(src, owner(2 * src + 1)) for src in range(n)]
        q_lo = ppermute(q[:, :h], group, perm_lo)
        q_hi = ppermute(q[:, h:], group, perm_hi)
        # rank r now holds half-blocks {r, 2n-1-r}: the even-indexed one
        # arrived by perm_lo, the odd one by perm_hi
        j_even, j_odd = (r, 2 * n - 1 - r) if r % 2 == 0 else (2 * n - 1 - r, r)
        qz = torch.cat([q_lo, q_hi], dim=1)
        ar = torch.arange(h, device=dev)
        q_idx = torch.cat([j_even * h + ar, j_odd * h + ar])
        mask = q_idx[:, None] >= torch.arange(s, device=dev)[None, :]
        out, _ = _chunk_attention_with_lse(qz, kg, vg, num_heads, scale, upcast, use_flash,
                                           mask=mask)
        out = out.to(q.dtype).reshape(b, sq_l, -1)
        o_lo = ppermute(out[:, :h], group, [(d, src) for src, d in perm_lo])
        o_hi = ppermute(out[:, h:], group, [(d, src) for src, d in perm_hi])
        return torch.cat([o_lo, o_hi], dim=1)

    # ring: the resident chunk first, then n-1 hops to the next rank
    diag = _causal_chunk_mask(sq_l, sq_l, r * sq_l, r * sq_l, dev) if causal else None
    out, acc_lse = _chunk_attention_with_lse(q, k, v, num_heads, scale, upcast, use_flash,
                                             mask=diag)
    acc_out = out.float()
    perm = [(i, (i + 1) % n) for i in range(n)]
    kc, vc = k, v
    for i in range(n - 1):
        kc = ppermute(kc, group, perm)
        vc = ppermute(vc, group, perm)
        mask = None
        if causal:
            # after hop i+1 the resident chunk came from rank (r - i - 1) mod
            # n; future chunks are fully masked and combine with weight 0
            src = (r - i - 1) % n
            mask = _causal_chunk_mask(sq_l, sq_l, r * sq_l, src * sq_l, dev)
        out_i, lse_i = _chunk_attention_with_lse(q, kc, vc, num_heads, scale, upcast,
                                                 use_flash, mask=mask)
        acc_out, acc_lse = _combine_chunks(acc_out, acc_lse, out_i, lse_i)
    return acc_out.to(q.dtype).reshape(b, sq_l, -1)
