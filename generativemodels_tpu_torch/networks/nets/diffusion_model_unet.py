"""Timestep-conditioned 2D/3D diffusion UNet, channels-first.

Counterpart of generativemodels_tpu/networks/nets/diffusion_model_unet.py:
ResnetBlock, Downsample, Upsample, DownBlock/MidBlock/UpBlock (self- or
cross-attention by level), DiffusionModelUNet with cross-attention
conditioning, class embedding, the ControlNet residual arguments and the
down-path cache (`cached_down`/`return_down`), and DiffusionModelEncoder.
Modules carry the reference's torch state-dict keys
(`down_blocks.{i}.resnets.{j}`, `.attentions.{j}` with
`.transformer_blocks.{k}` inside a SpatialTransformer, `time_embed.0/.2`,
`out.0/.2`, `<conv>.conv.weight`), so networks/convert.py maps JAX
parameters onto them one to one.

`dtype` mirrors the JAX module's mixed precision: parameters stay float32,
every conv, linear layer and GroupNorm computes in `dtype` (GroupNorm's
statistics in float32, as flax's), and the output is float32.
`use_checkpointing` recomputes block activations in the backward
(`torch.utils.checkpoint`, where the JAX module uses `nn.remat`).

With GMTPU_FUSED_RESBLOCK=1 (or "always"), read at each call as the JAX
module reads it at trace time, a 3D ResnetBlock that neither up- nor
downsamples runs `ResnetBlock._fused_call`: both of its GroupNorm-SiLU-conv
chains go through `ops.fused_norm_silu_conv3d` (kernel 5 on CUDA), with the
block's own parameters, so the state-dict keys do not change.
"""
from __future__ import annotations

import os
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops import fold_groupnorm_affine, fused_norm_silu_conv3d, get_timestep_embedding
from ...parallel.spatial import current_spatial_cut, halo_extend
from ..blocks.attention_blocks import AttentionBlock, SpatialTransformer
from ..blocks.convolutions import ConvND, avg_pool, upsample_nearest
from ..blocks.layers import GroupNorm, Linear

__all__ = [
    "DiffusionModelUNet",
    "DiffusionModelEncoder",
    "ResnetBlock",
    "Downsample",
    "Upsample",
    "DownBlock",
    "MidBlock",
    "UpBlock",
]


def ensure_tuple_rep(v, n: int) -> tuple:
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected sequence of length {n}, got {len(v)}")
        return tuple(v)
    return (v,) * n


def _run_block(remat: bool, block: nn.Module, *args):
    """`block(*args)`, recomputed in the backward when `remat` and autograd
    is recording."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


class Downsample(nn.Module):
    """Stride-2 conv (or avg-pool) downsampling."""

    def __init__(
        self,
        spatial_dims: int,
        num_channels: int,
        use_conv: bool,
        out_channels: int | None = None,
        padding: int = 1,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.num_channels = num_channels
        out_channels = out_channels or num_channels
        if use_conv:
            self.op = ConvND(
                spatial_dims, num_channels, out_channels, kernel_size=3, strides=2,
                padding=padding, dtype=dtype,
            )
        else:
            if num_channels != out_channels:
                raise ValueError("num_channels and out_channels must be equal when use_conv=False")
            self.op = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.num_channels:
            raise ValueError(f"Input channels ({x.shape[1]}) != expected ({self.num_channels})")
        return self.op(x) if self.op is not None else avg_pool(x, 2)


class Upsample(nn.Module):
    """Nearest x2 upsample with optional 3x3 conv."""

    def __init__(
        self,
        spatial_dims: int,
        num_channels: int,
        use_conv: bool,
        out_channels: int | None = None,
        padding: int = 1,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.num_channels = num_channels
        self.conv = (
            ConvND(
                spatial_dims, num_channels, out_channels or num_channels, kernel_size=3,
                padding=padding, nearest_upsample=True, dtype=dtype,
            )
            if use_conv
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.num_channels:
            raise ValueError("Input channels should be equal to num_channels")
        return self.conv(x) if self.conv is not None else upsample_nearest(x, 2)


def _fused_resblock_enabled() -> bool:
    """GMTPU_FUSED_RESBLOCK=1/always routes 3D interior ResnetBlocks
    through the fused kernel (ops/fused_conv.py), as in the JAX module."""
    return os.environ.get("GMTPU_FUSED_RESBLOCK", "0") in ("1", "always")


class ResnetBlock(nn.Module):
    """GroupNorm+SiLU conv block with additive timestep conditioning.

    norm1 -> silu -> [up/down] -> conv1 -> (+ time proj) -> norm2 -> silu ->
    conv2 (zero-init) -> + skip(x). The zero-initialised second conv makes a
    fresh block the identity. With GMTPU_FUSED_RESBLOCK set, the 3D
    non-resampling case runs `_fused_call`.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        temb_channels: int,
        out_channels: int | None = None,
        up: bool = False,
        down: bool = False,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.spatial_dims = spatial_dims
        self.up = up
        self.down = down
        self.dtype = dtype
        self.norm1 = GroupNorm(norm_num_groups, in_channels, norm_eps, dtype=dtype)
        self.conv1 = ConvND(
            spatial_dims, in_channels, out_channels, kernel_size=3, padding=1, dtype=dtype
        )
        self.time_emb_proj = Linear(temb_channels, out_channels, dtype=dtype)
        self.norm2 = GroupNorm(norm_num_groups, out_channels, norm_eps, dtype=dtype)
        self.conv2 = ConvND(
            spatial_dims, out_channels, out_channels, kernel_size=3, padding=1, zero_init=True,
            dtype=dtype,
        )
        self.skip_connection = (
            None
            if out_channels == in_channels
            else ConvND(spatial_dims, in_channels, out_channels, kernel_size=1, dtype=dtype)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if (
            self.spatial_dims == 3
            and not self.up
            and not self.down
            and _fused_resblock_enabled()
        ):
            return self._fused_call(x, emb)

        h = F.silu(self.norm1(x))
        if self.up:
            x = upsample_nearest(x, 2)
            h = upsample_nearest(h, 2)
        elif self.down:
            x = avg_pool(x, 2)
            h = avg_pool(h, 2)
        h = self.conv1(h)

        temb = self.time_emb_proj(F.silu(emb))
        h = h + temb.reshape(*temb.shape, *([1] * self.spatial_dims))

        h = self.conv2(F.silu(self.norm2(h)))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h

    def _fused_call(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """The JAX `_fused_call`: each GroupNorm-SiLU-conv chain is one
        `fused_norm_silu_conv3d`, from the block's own parameters.

        Layout: the kernel is channels-last and the port channels-first. The
        route hands it `x.permute(0, 2, 3, 4, 1)`, a (B, D, H, W, C) view of
        the channels-first tensor that the kernel reads through its strides,
        and gets back a view of a channels-first output: no layout copy.
        As in JAX, x is cast to the compute type before the statistics, the
        time projection is computed in float32 (the unfused route computes
        it in `dtype`), the temb is folded into norm2's affine instead of
        being added to h, and the residual is the skip in `dtype`.
        """
        dtype = self.dtype or x.dtype
        groups, eps = self.norm1.num_groups, self.norm1.eps
        cut = current_spatial_cut()
        group = None if cut is None else cut.group
        x = x.to(dtype).contiguous()

        def kernel(conv):  # (Cout, Cin, 3, 3, 3) -> (3, 3, 3, Cin, Cout), a view
            # cast to x's type where it is used: by the launcher on CUDA, by
            # the plain version on the CPU
            return conv.conv.weight.permute(2, 3, 4, 1, 0)

        s1, t1 = fold_groupnorm_affine(x.permute(0, 2, 3, 4, 1), self.norm1.weight,
                                       self.norm1.bias, groups, eps, group=group)
        h = _fused_conv_cf(x, kernel(self.conv1), s1, t1, self.conv1.conv.bias, None, cut)

        temb = F.linear(
            F.silu(emb.float()), self.time_emb_proj.weight, self.time_emb_proj.bias
        )  # (B, C) f32
        skip = x if self.skip_connection is None else self.skip_connection(x)

        s2, t2 = fold_groupnorm_affine(h.permute(0, 2, 3, 4, 1), self.norm2.weight,
                                       self.norm2.bias, groups, eps, temb=temb, group=group)
        return _fused_conv_cf(h, kernel(self.conv2), s2, t2, self.conv2.conv.bias,
                              skip.to(dtype), cut)


def _fused_conv_cf(x, w, scale, shift, bias, residual, cut) -> torch.Tensor:
    """`fused_norm_silu_conv3d` of channels-first x (B, C, D, H, W) through
    its channels-last view, returning channels-first (no layout copy).

    Under a spatial cut the kernel runs on the slab extended by one halo
    plane from each neighbour (none at the outer border, where the kernel's
    own zero padding of the activation is the uncut call's) and the planes
    of the slab are cropped from its output: the function the uncut call
    computes. The residual is padded with zeros to the extended depth.
    """
    if cut is None:
        res = None if residual is None else residual.permute(0, 2, 3, 4, 1)
        out = fused_norm_silu_conv3d(x.permute(0, 2, 3, 4, 1), w, scale, shift, bias=bias,
                                     residual=res)
        return out.permute(0, 4, 1, 2, 3)
    depth = x.shape[2]
    xe, lo = halo_extend(x, 1, 1, cut, border="none")
    res = None
    if residual is not None:
        hi = xe.shape[2] - depth - lo
        res = F.pad(residual, (0, 0, 0, 0, lo, hi)).permute(0, 2, 3, 4, 1)
    out = fused_norm_silu_conv3d(xe.permute(0, 2, 3, 4, 1), w, scale, shift, bias=bias,
                                 residual=res)
    return out.permute(0, 4, 1, 2, 3).narrow(2, lo, depth)


def _attention(
    spatial_dims: int,
    channels: int,
    cross: bool,
    num_head_channels: int,
    norm_num_groups: int,
    norm_eps: float,
    transformer_num_layers: int,
    cross_attention_dim: int | None,
    upcast_attention: bool,
    use_flash_attention: bool | None,
    dropout_cattn: float,
    dtype: torch.dtype | None,
) -> nn.Module:
    """A level's attention: a SpatialTransformer (`cross`, with_conditioning)
    or a self-attention AttentionBlock, as the JAX blocks choose."""
    if cross:
        return SpatialTransformer(
            spatial_dims, channels, channels // num_head_channels, num_head_channels,
            num_layers=transformer_num_layers, dropout=dropout_cattn,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            cross_attention_dim=cross_attention_dim, upcast_attention=upcast_attention,
            use_flash_attention=use_flash_attention, dtype=dtype,
        )
    return AttentionBlock(
        spatial_dims, channels, num_head_channels, norm_num_groups, norm_eps,
        use_flash_attention=use_flash_attention, dtype=dtype,
    )


def _apply_attention(block: nn.Module, h: torch.Tensor, context) -> torch.Tensor:
    if isinstance(block, SpatialTransformer):
        return block(h, context=context)
    return block(h)


class DownBlock(nn.Module):
    """Down path stage: [resnet (+ attn | xattn)] x N, then downsampler."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        temb_channels: int,
        num_res_blocks: int = 1,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        add_downsample: bool = True,
        resblock_updown: bool = False,
        downsample_padding: int = 1,
        with_attn: bool = False,
        with_cross_attn: bool = False,
        num_head_channels: int = 1,
        transformer_num_layers: int = 1,
        cross_attention_dim: int | None = None,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dropout_cattn: float = 0.0,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(
                spatial_dims, in_channels if i == 0 else out_channels, temb_channels,
                out_channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps, dtype=dtype,
            )
            for i in range(num_res_blocks)
        )
        self.attentions = (
            nn.ModuleList(
                _attention(
                    spatial_dims, out_channels, not with_attn, num_head_channels,
                    norm_num_groups, norm_eps, transformer_num_layers, cross_attention_dim,
                    upcast_attention, use_flash_attention, dropout_cattn, dtype,
                )
                for _ in range(num_res_blocks)
            )
            if with_attn or with_cross_attn
            else None
        )
        if not add_downsample:
            self.downsampler = None
        elif resblock_updown:
            self.downsampler = ResnetBlock(
                spatial_dims, out_channels, temb_channels, out_channels, down=True,
                norm_num_groups=norm_num_groups, norm_eps=norm_eps, dtype=dtype,
            )
        else:
            self.downsampler = Downsample(
                spatial_dims, out_channels, use_conv=True, out_channels=out_channels,
                padding=downsample_padding, dtype=dtype,
            )

    def forward(
        self,
        hidden_states: torch.Tensor,
        temb: torch.Tensor,
        context: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        output_states = []
        for i, resnet in enumerate(self.resnets):
            hidden_states = resnet(hidden_states, temb)
            if self.attentions is not None:
                hidden_states = _apply_attention(self.attentions[i], hidden_states, context)
            output_states.append(hidden_states)
        if self.downsampler is not None:
            if isinstance(self.downsampler, ResnetBlock):
                hidden_states = self.downsampler(hidden_states, temb)
            else:
                hidden_states = self.downsampler(hidden_states)
            output_states.append(hidden_states)
        return hidden_states, output_states


class MidBlock(nn.Module):
    """resnet -> (self- or cross-)attention -> resnet."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        temb_channels: int,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        with_conditioning: bool = False,
        num_head_channels: int = 1,
        transformer_num_layers: int = 1,
        cross_attention_dim: int | None = None,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dropout_cattn: float = 0.0,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()

        def resnet():
            return ResnetBlock(
                spatial_dims, in_channels, temb_channels, in_channels,
                norm_num_groups=norm_num_groups, norm_eps=norm_eps, dtype=dtype,
            )

        self.resnet_1 = resnet()
        self.attention = _attention(
            spatial_dims, in_channels, with_conditioning, num_head_channels, norm_num_groups,
            norm_eps, transformer_num_layers, cross_attention_dim, upcast_attention,
            use_flash_attention, dropout_cattn, dtype,
        )
        self.resnet_2 = resnet()

    def forward(
        self,
        hidden_states: torch.Tensor,
        temb: torch.Tensor,
        context: torch.Tensor | None = None,
    ) -> torch.Tensor:
        hidden_states = self.resnet_1(hidden_states, temb)
        hidden_states = _apply_attention(self.attention, hidden_states, context)
        return self.resnet_2(hidden_states, temb)


class UpBlock(nn.Module):
    """Up path stage: [cat skip, resnet (+ attn | xattn)] x N, then upsampler."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: int,
        num_res_blocks: int = 1,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        add_upsample: bool = True,
        resblock_updown: bool = False,
        with_attn: bool = False,
        with_cross_attn: bool = False,
        num_head_channels: int = 1,
        transformer_num_layers: int = 1,
        cross_attention_dim: int | None = None,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dropout_cattn: float = 0.0,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        resnets = []
        for i in range(num_res_blocks):
            res_skip_channels = in_channels if (i == num_res_blocks - 1) else out_channels
            resnet_in_channels = prev_output_channel if i == 0 else out_channels
            resnets.append(
                ResnetBlock(
                    spatial_dims, resnet_in_channels + res_skip_channels, temb_channels,
                    out_channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps, dtype=dtype,
                )
            )
        self.resnets = nn.ModuleList(resnets)
        self.attentions = (
            nn.ModuleList(
                _attention(
                    spatial_dims, out_channels, not with_attn, num_head_channels,
                    norm_num_groups, norm_eps, transformer_num_layers, cross_attention_dim,
                    upcast_attention, use_flash_attention, dropout_cattn, dtype,
                )
                for _ in range(num_res_blocks)
            )
            if with_attn or with_cross_attn
            else None
        )
        if not add_upsample:
            self.upsampler = None
        elif resblock_updown:
            self.upsampler = ResnetBlock(
                spatial_dims, out_channels, temb_channels, out_channels, up=True,
                norm_num_groups=norm_num_groups, norm_eps=norm_eps, dtype=dtype,
            )
        else:
            self.upsampler = Upsample(
                spatial_dims, out_channels, use_conv=True, out_channels=out_channels, dtype=dtype
            )

    def forward(
        self,
        hidden_states: torch.Tensor,
        res_hidden_states_list: list[torch.Tensor],
        temb: torch.Tensor,
        context: torch.Tensor | None = None,
    ) -> torch.Tensor:
        res_list = list(res_hidden_states_list)
        for i, resnet in enumerate(self.resnets):
            hidden_states = torch.cat([hidden_states, res_list.pop()], dim=1)
            hidden_states = resnet(hidden_states, temb)
            if self.attentions is not None:
                hidden_states = _apply_attention(self.attentions[i], hidden_states, context)
        if self.upsampler is not None:
            if isinstance(self.upsampler, ResnetBlock):
                hidden_states = self.upsampler(hidden_states, temb)
            else:
                hidden_states = self.upsampler(hidden_states)
        return hidden_states


def _validate_unet_args(
    num_channels,
    attention_levels,
    norm_num_groups,
    num_head_channels,
    num_res_blocks,
    with_conditioning,
    cross_attention_dim,
):
    if with_conditioning and cross_attention_dim is None:
        raise ValueError(
            "DiffusionModelUNet expects dimension of the cross-attention conditioning "
            "(cross_attention_dim) when using with_conditioning."
        )
    if cross_attention_dim is not None and not with_conditioning:
        raise ValueError(
            "DiffusionModelUNet expects with_conditioning=True when specifying the "
            "cross_attention_dim."
        )
    if any((c % norm_num_groups) != 0 for c in num_channels):
        raise ValueError("all num_channels must be multiples of norm_num_groups")
    if len(num_channels) != len(attention_levels):
        raise ValueError("num_channels must have the same length as attention_levels")
    if len(num_head_channels) != len(attention_levels):
        raise ValueError("num_head_channels must have the same length as attention_levels")
    if len(num_res_blocks) != len(num_channels):
        raise ValueError("num_res_blocks must have the same length as num_channels")


def _unet_config(
    num_channels, attention_levels, num_head_channels, num_res_blocks, norm_num_groups,
    with_conditioning, cross_attention_dim,
):
    """The checked per-level tuples (channels, attention, head widths, res
    blocks) of a UNet, encoder or ControlNet, as the JAX modules check them."""
    num_channels = tuple(num_channels)
    attention_levels = tuple(attention_levels)
    head_channels = ensure_tuple_rep(num_head_channels, len(attention_levels))
    res_blocks = ensure_tuple_rep(num_res_blocks, len(num_channels))
    _validate_unet_args(
        num_channels, attention_levels, norm_num_groups, head_channels, res_blocks,
        with_conditioning, cross_attention_dim,
    )
    return num_channels, attention_levels, head_channels, res_blocks


def _check_context(context, with_conditioning: bool) -> None:
    if context is not None and not with_conditioning:
        raise ValueError("model should have with_conditioning = True if context is provided")


def _time_embedding(num_channels0: int, num_class_embeds: int | None, dtype) -> tuple:
    """The time embedding MLP (`time_embed.0/.2`) and, with class embeds,
    the class embedding table."""
    time_embed_dim = num_channels0 * 4
    time_embed = nn.Sequential(
        Linear(num_channels0, time_embed_dim, dtype=dtype),
        nn.SiLU(),
        Linear(time_embed_dim, time_embed_dim, dtype=dtype),
    )
    class_embedding = (
        nn.Embedding(num_class_embeds, time_embed_dim) if num_class_embeds is not None else None
    )
    return time_embed, class_embedding


def _embed(module: nn.Module, x: torch.Tensor, timesteps, class_labels) -> torch.Tensor:
    """The timestep (+ class) embedding of a UNet, encoder or ControlNet."""
    t_emb = get_timestep_embedding(timesteps, module.num_channels[0]).to(x.dtype)
    emb = module.time_embed(t_emb)
    if module.num_class_embeds is not None:
        if class_labels is None:
            raise ValueError("class_labels should be provided when num_class_embeds > 0")
        emb = emb + module.class_embedding(class_labels).to(emb.dtype)
    return emb


class DiffusionModelUNet(nn.Module):
    """UNet with timestep embedding and attention or cross-attention levels.

    Forward contract: ``model(x, timesteps, context=None, class_labels=None,
    down_block_additional_residuals=None, mid_block_additional_residual=None,
    cached_down=None, return_down=False)`` with x in (B, C, *spatial);
    returns float32 (B, out_channels, *spatial).

    Args mirror the JAX module's. With `with_conditioning` every attention
    level (and the mid block) is a SpatialTransformer over `context` (B, S,
    cross_attention_dim), `transformer_num_layers` blocks deep, with the
    reference's `upcast_attention` and `dropout_cattn`.
    `use_checkpointing` is a bool (every block) or one entry per level; the
    mid block follows the last entry. `dtype` is the computation type (e.g.
    torch.bfloat16).
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        num_res_blocks: Sequence[int] | int = (2, 2, 2, 2),
        num_channels: Sequence[int] = (32, 64, 64, 64),
        attention_levels: Sequence[bool] = (False, False, True, True),
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        resblock_updown: bool = False,
        num_head_channels: int | Sequence[int] = 8,
        with_conditioning: bool = False,
        transformer_num_layers: int = 1,
        cross_attention_dim: int | None = None,
        num_class_embeds: int | None = None,
        upcast_attention: bool = False,
        use_flash_attention: bool | None = None,
        dropout_cattn: float = 0.0,
        use_checkpointing: bool | Sequence[bool] = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        if not 0.0 <= dropout_cattn <= 1.0:
            raise ValueError("Dropout cannot be negative or >1.0!")
        num_channels, attention_levels, head_channels, res_blocks = _unet_config(
            num_channels, attention_levels, num_head_channels, num_res_blocks, norm_num_groups,
            with_conditioning, cross_attention_dim,
        )
        if isinstance(use_checkpointing, bool):
            use_checkpointing = (use_checkpointing,) * len(num_channels)
        else:
            use_checkpointing = tuple(bool(c) for c in use_checkpointing)
            if len(use_checkpointing) != len(num_channels):
                raise ValueError(
                    "use_checkpointing sequence must have one entry per level: "
                    f"got {len(use_checkpointing)} for {len(num_channels)} levels"
                )
        self.spatial_dims = spatial_dims
        self.num_channels = num_channels
        self.num_class_embeds = num_class_embeds
        self.with_conditioning = with_conditioning
        self.use_checkpointing = use_checkpointing
        self.dtype = dtype

        time_embed_dim = num_channels[0] * 4
        self.time_embed, class_embedding = _time_embedding(num_channels[0], num_class_embeds,
                                                           dtype)
        if class_embedding is not None:
            self.class_embedding = class_embedding
        self.conv_in = ConvND(
            spatial_dims, in_channels, num_channels[0], kernel_size=3, padding=1, dtype=dtype
        )

        common = dict(
            spatial_dims=spatial_dims, temb_channels=time_embed_dim,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            transformer_num_layers=transformer_num_layers,
            cross_attention_dim=cross_attention_dim, upcast_attention=upcast_attention,
            use_flash_attention=use_flash_attention, dropout_cattn=dropout_cattn, dtype=dtype,
        )
        down_blocks = []
        output_channel = num_channels[0]
        for i in range(len(num_channels)):
            input_channel = output_channel
            output_channel = num_channels[i]
            down_blocks.append(
                DownBlock(
                    in_channels=input_channel, out_channels=output_channel,
                    num_res_blocks=res_blocks[i], add_downsample=i < len(num_channels) - 1,
                    resblock_updown=resblock_updown,
                    with_attn=attention_levels[i] and not with_conditioning,
                    with_cross_attn=attention_levels[i] and with_conditioning,
                    num_head_channels=head_channels[i], **common,
                )
            )
        self.down_blocks = nn.ModuleList(down_blocks)

        self.middle_block = MidBlock(
            in_channels=num_channels[-1], with_conditioning=with_conditioning,
            num_head_channels=head_channels[-1], **common,
        )

        up_blocks = []
        reversed_channels = list(reversed(num_channels))
        reversed_res_blocks = list(reversed(res_blocks))
        reversed_attention = list(reversed(attention_levels))
        reversed_heads = list(reversed(head_channels))
        output_channel = reversed_channels[0]
        for i in range(len(reversed_channels)):
            prev_output_channel = output_channel
            output_channel = reversed_channels[i]
            input_channel = reversed_channels[min(i + 1, len(num_channels) - 1)]
            up_blocks.append(
                UpBlock(
                    in_channels=input_channel, prev_output_channel=prev_output_channel,
                    out_channels=output_channel, num_res_blocks=reversed_res_blocks[i] + 1,
                    add_upsample=i < len(num_channels) - 1, resblock_updown=resblock_updown,
                    with_attn=reversed_attention[i] and not with_conditioning,
                    with_cross_attn=reversed_attention[i] and with_conditioning,
                    num_head_channels=reversed_heads[i], **common,
                )
            )
        self.up_blocks = nn.ModuleList(up_blocks)

        self.out = nn.Sequential(
            GroupNorm(norm_num_groups, num_channels[0], norm_eps, dtype=dtype),
            nn.SiLU(),
            ConvND(spatial_dims, num_channels[0], out_channels, kernel_size=3, padding=1,
                   zero_init=True, dtype=dtype),
        )

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor | None = None,
        class_labels: torch.Tensor | None = None,
        down_block_additional_residuals: Sequence[torch.Tensor] | None = None,
        mid_block_additional_residual: torch.Tensor | None = None,
        cached_down: tuple | None = None,
        return_down: bool = False,
    ):
        """The prediction for x at `timesteps`.

        `cached_down` / `return_down` reuse the down path's features across
        adjacent sampling timesteps, as the JAX module does: with
        `return_down` the call also returns `(h, down_block_res_samples)`
        (the port's channels-first features); passing that back as
        `cached_down` skips the down path (an approximation: the features
        hold the timestep they were computed at).
        """
        _check_context(context, self.with_conditioning)

        if self.dtype is not None:
            x = x.to(self.dtype)

        # 1.-2. time (and class) embedding
        emb = _embed(self, x, timesteps, class_labels)

        # 3. initial convolution
        h = self.conv_in(x)

        # 4. down path, skipped when cached features come in; level i's
        # blocks recompute in the backward when use_checkpointing[i] (the
        # mid block follows the last level)
        remat = self.use_checkpointing
        if cached_down is not None:
            h, cached_res = cached_down
            down_block_res_samples = list(cached_res)
        else:
            down_block_res_samples = [h]
            for level, block in enumerate(self.down_blocks):
                h, res_samples = _run_block(remat[level], block, h, emb, context)
                down_block_res_samples.extend(res_samples)
        down_cache = (h, tuple(down_block_res_samples))

        # ControlNet residual injection
        if down_block_additional_residuals is not None:
            down_block_res_samples = [
                s + r.to(s.dtype)
                for s, r in zip(down_block_res_samples, down_block_additional_residuals)
            ]

        # 5. mid
        h = _run_block(remat[-1], self.middle_block, h, emb, context)
        if mid_block_additional_residual is not None:
            h = h + mid_block_additional_residual.to(h.dtype)

        # 6. up path
        for i, block in enumerate(self.up_blocks):
            n_res = len(block.resnets)
            res_samples = down_block_res_samples[-n_res:]
            down_block_res_samples = down_block_res_samples[:-n_res]
            h = _run_block(remat[len(remat) - 1 - i], block, h, res_samples, emb, context)

        # 7. output head (zero-init conv)
        out = self.out(h).float()
        return (out, down_cache) if return_down else out


class DiffusionModelEncoder(nn.Module):
    """Down path and a linear head, for classification at a diffusion time.

    Counterpart of the JAX module, itself the reference's (which hard-codes
    the head's input width at 4096). Every level downsamples (the
    reference's final-block test never fires). The head flattens the last
    features channels-first, as the reference does; the JAX module flattens
    channels-last, and networks/convert.py permutes the head's rows between
    the two. Its first Linear (`out.0`) takes its input width from the
    first forward, as flax's Dense does at init: run one forward before
    reading or loading its parameters.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        num_res_blocks: Sequence[int] | int = (2, 2, 2, 2),
        num_channels: Sequence[int] = (32, 64, 64, 64),
        attention_levels: Sequence[bool] = (False, False, True, True),
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        resblock_updown: bool = False,
        num_head_channels: int | Sequence[int] = 8,
        with_conditioning: bool = False,
        transformer_num_layers: int = 1,
        cross_attention_dim: int | None = None,
        num_class_embeds: int | None = None,
        upcast_attention: bool = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels, attention_levels, head_channels, res_blocks = _unet_config(
            num_channels, attention_levels, num_head_channels, num_res_blocks, norm_num_groups,
            with_conditioning, cross_attention_dim,
        )
        self.num_channels = num_channels
        self.num_class_embeds = num_class_embeds
        self.with_conditioning = with_conditioning
        self.dtype = dtype
        self.time_embed, class_embedding = _time_embedding(num_channels[0], num_class_embeds,
                                                           dtype)
        if class_embedding is not None:
            self.class_embedding = class_embedding
        self.conv_in = ConvND(
            spatial_dims, in_channels, num_channels[0], kernel_size=3, padding=1, dtype=dtype
        )
        down_blocks = []
        output_channel = num_channels[0]
        for i in range(len(num_channels)):
            input_channel = output_channel
            output_channel = num_channels[i]
            down_blocks.append(
                DownBlock(
                    spatial_dims, input_channel, output_channel, num_channels[0] * 4,
                    num_res_blocks=res_blocks[i], norm_num_groups=norm_num_groups,
                    norm_eps=norm_eps, add_downsample=True, resblock_updown=resblock_updown,
                    with_attn=attention_levels[i] and not with_conditioning,
                    with_cross_attn=attention_levels[i] and with_conditioning,
                    num_head_channels=head_channels[i],
                    transformer_num_layers=transformer_num_layers,
                    cross_attention_dim=cross_attention_dim, upcast_attention=upcast_attention,
                    dtype=dtype,
                )
            )
        self.down_blocks = nn.ModuleList(down_blocks)
        self.out = nn.Sequential(
            nn.LazyLinear(512), nn.ReLU(), nn.Dropout(0.1), nn.Linear(512, out_channels)
        )

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        context: torch.Tensor | None = None,
        class_labels: torch.Tensor | None = None,
    ) -> torch.Tensor:
        _check_context(context, self.with_conditioning)
        if self.dtype is not None:
            x = x.to(self.dtype)
        emb = _embed(self, x, timesteps, class_labels)
        h = self.conv_in(x)
        for block in self.down_blocks:
            h, _ = block(h, emb, context)
        # channels-first flatten, the head in float32
        return self.out(h.reshape(h.shape[0], -1).float())
