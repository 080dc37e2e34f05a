"""Decoder-only (autoregressive) transformer.

Counterpart of generativemodels_tpu/networks/nets/transformer.py
(`DecoderOnlyTransformer`), with the reference's torch keys:
`token_embeddings`, `position_embeddings.embedding`, `blocks.{i}.…` and
`to_logits`. Its blocks are causal; from 1024 tokens on a CUDA tensor their
self-attention runs on the flash kernels (`ops.dot_product_attention`'s
rule: head widths 32, 64, 128 and 256).

Decoding: `init_cache(batch)` makes a `TransformerCache` (one `KVCache` a
block and the position of the next token); `model(tokens, cache=cache)`
with one token a row returns (logits, the advanced cache). The position
embedding of a decode step is the cache's position, as the JAX module's
`pos_index`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..blocks.selfattention import KVCache, TransformerBlock

__all__ = ["AbsolutePositionalEmbedding", "DecoderOnlyTransformer", "TransformerCache"]


@dataclass
class TransformerCache:
    """The decoding state of a DecoderOnlyTransformer: one KVCache a block
    and the position the next token takes."""

    blocks: list[KVCache]
    position: int = 0


class AbsolutePositionalEmbedding(nn.Module):
    """A learned embedding of the positions 0..max_seq_len-1 (the
    reference's holder module, hence the `.embedding` key)."""

    def __init__(self, max_seq_len: int, embedding_dim: int) -> None:
        super().__init__()
        self.embedding = nn.Embedding(max_seq_len, embedding_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding(torch.arange(x.shape[1], device=x.device))[None]


class DecoderOnlyTransformer(nn.Module):
    """GPT-style model over token sequences (B, S) -> logits (B, S, num_tokens).

    `dtype` is the blocks' computation type; the embeddings add in float32
    and `to_logits` applies to the last hidden state cast to float32, as in
    JAX, so the logits are float32 whatever `dtype`.
    """

    def __init__(
        self,
        num_tokens: int,
        max_seq_len: int,
        attn_layers_dim: int,
        attn_layers_depth: int,
        attn_layers_heads: int,
        with_cross_attention: bool = False,
        embedding_dropout_rate: float = 0.0,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.num_tokens = num_tokens
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.token_embeddings = nn.Embedding(num_tokens, attn_layers_dim)
        self.position_embeddings = AbsolutePositionalEmbedding(max_seq_len, attn_layers_dim)
        self.embedding_dropout = nn.Dropout(embedding_dropout_rate)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                hidden_size=attn_layers_dim, mlp_dim=attn_layers_dim * 4,
                num_heads=attn_layers_heads, dropout_rate=0.0, qkv_bias=False, causal=True,
                sequence_length=max_seq_len, with_cross_attention=with_cross_attention,
                use_flash_attention=use_flash_attention, dtype=dtype,
            )
            for _ in range(attn_layers_depth)
        )
        self.to_logits = nn.Linear(attn_layers_dim, num_tokens)

    def init_cache(self, batch: int, device: torch.device | str | None = None) -> TransformerCache:
        """An empty decoding state for `batch` rows (on the parameters'
        device unless `device` is given)."""
        device = device if device is not None else self.to_logits.weight.device
        return TransformerCache([block.attn.init_cache(batch, device) for block in self.blocks])

    def forward(
        self,
        x: torch.Tensor,
        context: torch.Tensor | None = None,
        cache: TransformerCache | None = None,
    ):
        """Logits of `x` (B, S) int; with `cache`, (logits, the advanced cache)."""
        tok_emb = self.token_embeddings(x)
        if cache is None:
            pos_emb = self.position_embeddings(x)
        else:
            pos_emb = self.position_embeddings.embedding.weight[cache.position][None, None]
        h = tok_emb + pos_emb
        if self.dtype is not None:
            h = h.to(self.dtype)
        h = self.embedding_dropout(h)
        if cache is None:
            for block in self.blocks:
                h = block(h, context=context)
            return self.to_logits(h.float())
        block_caches = []
        for block, block_cache in zip(self.blocks, cache.blocks):
            h, block_cache = block(h, context=context, cache=block_cache)
            block_caches.append(block_cache)
        return self.to_logits(h.float()), TransformerCache(block_caches, cache.position + 1)
