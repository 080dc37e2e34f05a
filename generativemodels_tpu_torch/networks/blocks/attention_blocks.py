"""Spatial self-attention block for diffusion nets, channels-first.

Counterpart of generativemodels_tpu/networks/blocks/attention_blocks.py
(`AttentionBlock` only so far). Attention goes through
ops.dot_product_attention, which takes the flash kernels on CUDA tensors at
long sequences, forward and backward.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import dot_product_attention
from .layers import GroupNorm, Linear


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
