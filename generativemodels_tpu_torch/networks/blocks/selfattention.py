"""Self-attention block (GPT style), causal, cross or decoding with a KV cache.

Counterpart of generativemodels_tpu/networks/blocks/selfattention.py:
`SABlock` and the pre-LN `TransformerBlock`, with the reference's torch
keys (`to_q`, `to_k`, `to_v` with `qkv_bias`, `out_proj`; `norm1`, `attn`,
`norm2`, `cross_attn`, `norm3`, `mlp.linear1/linear2`).

Decoding keeps the keys and values of earlier tokens in a `KVCache`, one per
block, that the caller makes (`SABlock.init_cache`), passes in and gets back,
where the JAX module keeps a flax "cache" collection. A decode call writes
its keys and values at the cache's index, in place, attends over the rows
`arange(sequence_length) <= index` through the masked (plain) attention
path, and returns the cache with its index advanced by one.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...ops import dot_product_attention
from .layers import LayerNorm, Linear
from .mlp import MLPBlock


@dataclass
class KVCache:
    """One block's decoding state: keys and values, (B, sequence_length,
    hidden_size) each, and the row the next call writes."""

    key: torch.Tensor
    value: torch.Tensor
    index: int = 0


class SABlock(nn.Module):
    """Multi-head attention over (B, S, C): causal, cross (keys and values
    from `context`, which is `hidden_size` wide as in the reference) or,
    given a `cache`, one decoding step. `with_cross_attention` is accepted
    for the JAX signature; a `context` is what makes a call cross-attend.

    `dtype` is the computation type of the four projections (parameters stay
    float32); `use_flash_attention` goes to `dot_product_attention`.
    """

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        qkv_bias: bool = False,
        causal: bool = False,
        sequence_length: int | None = None,
        with_cross_attention: bool = False,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        if not 0 <= dropout_rate <= 1:
            raise ValueError("dropout_rate should be between 0 and 1.")
        if hidden_size % num_heads != 0:
            raise ValueError("hidden size should be divisible by num_heads.")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.causal = causal
        self.sequence_length = sequence_length
        self.use_flash_attention = use_flash_attention
        self.dtype = dtype
        self.to_q = Linear(hidden_size, hidden_size, dtype=dtype, bias=qkv_bias)
        self.to_k = Linear(hidden_size, hidden_size, dtype=dtype, bias=qkv_bias)
        self.to_v = Linear(hidden_size, hidden_size, dtype=dtype, bias=qkv_bias)
        self.out_proj = Linear(hidden_size, hidden_size, dtype=dtype)
        self.drop = nn.Dropout(dropout_rate)

    def init_cache(self, batch: int, device: torch.device | str | None = None) -> KVCache:
        """An empty cache of `sequence_length` rows, in the keys' type."""
        if self.sequence_length is None:
            raise ValueError("sequence_length is required for decode mode")
        shape = (batch, self.sequence_length, self.hidden_size)
        dtype = self.dtype or self.to_k.weight.dtype
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor | None = None,
        cache: KVCache | None = None,
    ):
        """(B, S, C) -> (B, S, C); with `cache`, (output, the advanced cache)."""
        q = self.to_q(x)
        kv = context if context is not None else x
        k = self.to_k(kv)
        v = self.to_v(kv)
        if cache is None:
            y = dot_product_attention(q, k, v, self.num_heads, causal=self.causal,
                                      use_flash=self.use_flash_attention)
            return self.drop(self.out_proj(y))
        idx, rows = cache.index, k.shape[1]
        cache.key[:, idx:idx + rows] = k.to(cache.key.dtype)
        cache.value[:, idx:idx + rows] = v.to(cache.value.dtype)
        key_mask = (torch.arange(cache.key.shape[1], device=x.device) <= idx)[None, None, :]
        y = dot_product_attention(q, cache.key, cache.value, self.num_heads, mask=key_mask,
                                  use_flash=False)
        return self.drop(self.out_proj(y)), KVCache(cache.key, cache.value, idx + 1)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(norm1(x)); [x + cross_attn(norm2(x), context)];
    x + mlp(norm3(x)). LayerNorm eps 1e-6 and the tanh GELU, as flax's."""

    def __init__(
        self,
        hidden_size: int,
        mlp_dim: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        qkv_bias: bool = False,
        causal: bool = False,
        sequence_length: int | None = None,
        with_cross_attention: bool = False,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.with_cross_attention = with_cross_attention
        self.norm1 = LayerNorm(hidden_size, dtype=dtype)
        self.attn = SABlock(
            hidden_size, num_heads, dropout_rate, qkv_bias, causal=causal,
            sequence_length=sequence_length, use_flash_attention=use_flash_attention,
            dtype=dtype,
        )
        if with_cross_attention:
            self.norm2 = LayerNorm(hidden_size, dtype=dtype)
            self.cross_attn = SABlock(
                hidden_size, num_heads, dropout_rate, qkv_bias, with_cross_attention=True,
                causal=False, use_flash_attention=use_flash_attention, dtype=dtype,
            )
        self.norm3 = LayerNorm(hidden_size, dtype=dtype)
        self.mlp = MLPBlock(hidden_size, mlp_dim, act="GELU", dropout_rate=dropout_rate,
                            dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor | None = None,
        cache: KVCache | None = None,
    ):
        """(B, S, C) -> (B, S, C); with `cache`, (output, the advanced cache)."""
        if cache is None:
            x = x + self.attn(self.norm1(x))
        else:
            y, cache = self.attn(self.norm1(x), cache=cache)
            x = x + y
        if self.with_cross_attention:
            x = x + self.cross_attn(self.norm2(x), context=context)
        x = x + self.mlp(self.norm3(x))
        return x if cache is None else (x, cache)
