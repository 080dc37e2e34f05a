"""Attention blocks for diffusion nets, channels-first.

Counterpart of generativemodels_tpu/networks/blocks/attention_blocks.py:
`CrossAttention`, `BasicTransformerBlock`, `SpatialTransformer` and
`AttentionBlock`, with the reference's torch state-dict keys (`to_q`,
`to_k`, `to_v` without a bias, `to_out.0`, `norm1`-`norm3`, `ff.linear1`,
`ff.linear2`, `proj_in.conv`, `transformer_blocks.{i}`, `proj_out.conv`).
Attention goes through ops.dot_product_attention, which takes the flash
kernels on CUDA tensors at long sequences, forward and backward, in the
contract `upcast_attention` names.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import dot_product_attention
from .convolutions import ConvND
from .layers import GroupNorm, LayerNorm, Linear
from .mlp import MLPBlock


class CrossAttention(nn.Module):
    """Multi-head (cross-)attention over (B, S, C) sequences: q from x, k and
    v from the context (x itself when there is none).

    `upcast_attention` is the reference's f32 island: f32 operands for the
    score product (the flash kernels' upcast contract). `dtype` is the
    computation type of the projections; the context is cast to it by the
    projections, as flax's `Dense(dtype=)` casts its input.
    """

    def __init__(
        self,
        query_dim: int,
        cross_attention_dim: int | None = None,
        num_attention_heads: int = 8,
        num_head_channels: int = 64,
        dropout: float = 0.0,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        inner_dim = num_head_channels * num_attention_heads
        context_dim = cross_attention_dim or query_dim
        self.num_attention_heads = num_attention_heads
        self.scale = 1.0 / (num_head_channels**0.5)
        self.upcast_attention = upcast_attention
        self.use_flash_attention = use_flash_attention
        self.to_q = Linear(query_dim, inner_dim, dtype=dtype, bias=False)
        self.to_k = Linear(context_dim, inner_dim, dtype=dtype, bias=False)
        self.to_v = Linear(context_dim, inner_dim, dtype=dtype, bias=False)
        self.to_out = nn.Sequential(Linear(inner_dim, query_dim, dtype=dtype), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        # a context is whole on every rank: never cut by sequence sharding
        seq_shard = None if context is None else False
        context = x if context is None else context
        out = dot_product_attention(
            self.to_q(x),
            self.to_k(context),
            self.to_v(context),
            self.num_attention_heads,
            scale=self.scale,
            upcast=self.upcast_attention,
            use_flash=self.use_flash_attention,
            seq_shard=seq_shard,
        )
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    """self-attention -> cross-attention -> GEGLU MLP, each after a
    LayerNorm (eps 1e-6, flax's) and with a residual."""

    def __init__(
        self,
        num_channels: int,
        num_attention_heads: int,
        num_head_channels: int,
        dropout: float = 0.0,
        cross_attention_dim: int | None = None,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        attn = dict(
            query_dim=num_channels, num_attention_heads=num_attention_heads,
            num_head_channels=num_head_channels, dropout=dropout,
            upcast_attention=upcast_attention, use_flash_attention=use_flash_attention,
            dtype=dtype,
        )
        self.attn1 = CrossAttention(**attn)
        self.ff = MLPBlock(num_channels, num_channels * 4, act="GEGLU", dropout_rate=dropout,
                           dtype=dtype)
        self.attn2 = CrossAttention(cross_attention_dim=cross_attention_dim, **attn)
        self.norm1 = LayerNorm(num_channels, dtype=dtype)
        self.norm2 = LayerNorm(num_channels, dtype=dtype)
        self.norm3 = LayerNorm(num_channels, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Transformer over the flattened spatial positions of (B, C, *spatial):
    GroupNorm -> 1x1 conv in -> `num_layers` BasicTransformerBlocks -> 1x1
    conv out (zero-initialised) -> residual. Positions flatten row-major,
    as the channels-last JAX module flattens them."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        num_attention_heads: int,
        num_head_channels: int,
        num_layers: int = 1,
        dropout: float = 0.0,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        cross_attention_dim: int | None = None,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        inner_dim = num_attention_heads * num_head_channels
        self.norm = GroupNorm(norm_num_groups, in_channels, eps=norm_eps, dtype=dtype)
        self.proj_in = ConvND(spatial_dims, in_channels, inner_dim, kernel_size=1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(
                inner_dim, num_attention_heads, num_head_channels, dropout=dropout,
                cross_attention_dim=cross_attention_dim, upcast_attention=upcast_attention,
                use_flash_attention=use_flash_attention, dtype=dtype,
            )
            for _ in range(num_layers)
        )
        self.proj_out = ConvND(spatial_dims, inner_dim, in_channels, kernel_size=1,
                               zero_init=True, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        b = x.shape[0]
        spatial_shape = x.shape[2:]
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.reshape(b, inner, -1).transpose(1, 2)  # (B, S, inner)
        for block in self.transformer_blocks:
            h = block(h, context=context)
        h = h.transpose(1, 2).reshape(b, inner, *spatial_shape)
        return self.proj_out(h) + x


class AttentionBlock(nn.Module):
    """Spatial self-attention block: GroupNorm -> qkv attention -> residual.

    Reference-parity quirk: the reference defines a `proj_attn` output
    projection but never applies it in forward, and trained checkpoints bake
    that in, so by default there is no output projection and no dead
    parameter. `apply_final_proj=True` adds a real one (not loadable from
    reference checkpoints). `dtype` is the computation type of the norm and
    the projections (parameters stay float32).
    """

    def __init__(
        self,
        spatial_dims: int,
        num_channels: int,
        num_head_channels: int | None = None,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        use_flash_attention: bool | None = None,
        apply_final_proj: bool = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.spatial_dims = spatial_dims
        self.num_channels = num_channels
        self.num_heads = num_channels // num_head_channels if num_head_channels is not None else 1
        self.use_flash_attention = use_flash_attention
        self.norm = GroupNorm(norm_num_groups, num_channels, eps=norm_eps, dtype=dtype)
        self.to_q = Linear(num_channels, num_channels, dtype=dtype)
        self.to_k = Linear(num_channels, num_channels, dtype=dtype)
        self.to_v = Linear(num_channels, num_channels, dtype=dtype)
        self.proj_attn = (
            Linear(num_channels, num_channels, dtype=dtype) if apply_final_proj else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        spatial_shape = x.shape[2:]
        # (B, C, *spatial) -> (B, S, C), spatial axes flattened row-major
        h = self.norm(x).reshape(b, c, -1).transpose(1, 2)

        out = dot_product_attention(
            self.to_q(h),
            self.to_k(h),
            self.to_v(h),
            self.num_heads,
            scale=1.0 / ((self.num_channels / self.num_heads) ** 0.5),
            use_flash=self.use_flash_attention,
        )
        if self.proj_attn is not None:
            out = self.proj_attn(out)
        out = out.transpose(1, 2).reshape(b, c, *spatial_shape)
        return out + x
