"""SPADE-conditioned diffusion UNet (segmentation conditioning on the up path).

Counterpart of generativemodels_tpu/networks/nets/spade_diffusion_model_unet.py:
`SPADEResnetBlock`, `SPADEUpBlock` (with self- or cross-attention levels)
and `SPADEDiffusionModelUNet`. The down and mid paths are the port's
`DownBlock` and `MidBlock`; the up path's res blocks normalise with SPADE
(an affine GroupNorm at `norm_eps`, then the segmentation's gamma and beta).
The keys are the UNet's (`down_blocks...`, `up_blocks.{i}.resnets.{j}.norm1.
mlp_shared.conv.weight`, `...norm1.param_free_norm.N.weight`, `out.0/.2`).
`forward(x, timesteps, seg, ...)`; `label_nc` is read by the inferers.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.convolutions import ConvND, avg_pool, upsample_nearest
from ..blocks.layers import GroupNorm, Linear
from ..blocks.spade_norm import SPADE
from .diffusion_model_unet import (
    DownBlock,
    MidBlock,
    Upsample,
    _apply_attention,
    _attention,
    _check_context,
    _embed,
    _time_embedding,
    _unet_config,
)

__all__ = ["SPADEDiffusionModelUNet", "SPADEResnetBlock", "SPADEUpBlock"]


class SPADEResnetBlock(nn.Module):
    """The UNet's ResnetBlock with SPADE norms: norm1(x, seg) -> silu ->
    [up/down] -> conv1 -> (+ time proj) -> norm2(., seg) -> silu -> conv2
    (zero-init) -> + skip(x)."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        temb_channels: int,
        label_nc: int,
        out_channels: int | None = None,
        up: bool = False,
        down: bool = False,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        spade_intermediate_channels: int = 128,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.spatial_dims = spatial_dims
        self.up = up
        self.down = down

        def spade(nc):
            return SPADE(
                label_nc, nc, kernel_size=3, spatial_dims=spatial_dims,
                hidden_channels=spade_intermediate_channels, norm="GROUP",
                norm_params={"num_groups": norm_num_groups, "eps": norm_eps, "affine": True},
                dtype=dtype,
            )

        self.norm1 = spade(in_channels)
        self.conv1 = ConvND(spatial_dims, in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.time_emb_proj = Linear(temb_channels, out_channels, dtype=dtype)
        self.norm2 = spade(out_channels)
        self.conv2 = ConvND(spatial_dims, out_channels, out_channels, 3, padding=1,
                            zero_init=True, dtype=dtype)
        self.skip_connection = (
            None if out_channels == in_channels
            else ConvND(spatial_dims, in_channels, out_channels, 1, dtype=dtype)
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(x, seg))
        if self.up:
            x = upsample_nearest(x, 2)
            h = upsample_nearest(h, 2)
        elif self.down:
            x = avg_pool(x, 2)
            h = avg_pool(h, 2)
        h = self.conv1(h)
        temb = self.time_emb_proj(F.silu(emb))
        h = h + temb.reshape(*temb.shape, *([1] * self.spatial_dims))
        h = self.conv2(F.silu(self.norm2(h, seg)))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


class SPADEUpBlock(nn.Module):
    """Up path stage: [cat skip, SPADE resnet (+ attn | xattn)] x N, then an
    upsampler (a SPADE resnet with `resblock_updown`, else a conv)."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        prev_output_channel: int,
        out_channels: int,
        temb_channels: int,
        label_nc: int,
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
        spade_intermediate_channels: int = 128,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        spade = dict(label_nc=label_nc, norm_num_groups=norm_num_groups, norm_eps=norm_eps,
                     spade_intermediate_channels=spade_intermediate_channels, dtype=dtype)
        self.resnets = nn.ModuleList(
            SPADEResnetBlock(
                spatial_dims,
                (prev_output_channel if i == 0 else out_channels)
                + (in_channels if i == num_res_blocks - 1 else out_channels),
                temb_channels, out_channels=out_channels, **spade,
            )
            for i in range(num_res_blocks)
        )
        self.attentions = (
            nn.ModuleList(
                _attention(
                    spatial_dims, out_channels, not with_attn, num_head_channels,
                    norm_num_groups, norm_eps, transformer_num_layers, cross_attention_dim,
                    upcast_attention, use_flash_attention, 0.0, dtype,
                )
                for _ in range(num_res_blocks)
            )
            if with_attn or with_cross_attn else None
        )
        if not add_upsample:
            self.upsampler = None
        elif resblock_updown:
            self.upsampler = SPADEResnetBlock(spatial_dims, out_channels, temb_channels,
                                              out_channels=out_channels, up=True, **spade)
        else:
            self.upsampler = Upsample(spatial_dims, out_channels, use_conv=True,
                                      out_channels=out_channels, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,
        res_hidden_states_list: list[torch.Tensor],
        temb: torch.Tensor,
        seg: torch.Tensor,
        context: torch.Tensor | None = None,
    ) -> torch.Tensor:
        res_list = list(res_hidden_states_list)
        for i, resnet in enumerate(self.resnets):
            hidden_states = torch.cat([hidden_states, res_list.pop()], dim=1)
            hidden_states = resnet(hidden_states, temb, seg)
            if self.attentions is not None:
                hidden_states = _apply_attention(self.attentions[i], hidden_states, context)
        if isinstance(self.upsampler, SPADEResnetBlock):
            hidden_states = self.upsampler(hidden_states, temb, seg)
        elif self.upsampler is not None:
            hidden_states = self.upsampler(hidden_states)
        return hidden_states


class SPADEDiffusionModelUNet(nn.Module):
    """DiffusionModelUNet with a SPADE-normalised up path.

    Forward contract: ``model(x, timesteps, seg, context=None,
    class_labels=None, down_block_additional_residuals=None,
    mid_block_additional_residual=None)``, x (B, C, *spatial) and seg (B,
    label_nc, *spatial at any resolution: each SPADE resizes it); returns
    float32 (B, out_channels, *spatial). Arguments mirror the JAX module's.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        label_nc: int,
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
        spade_intermediate_channels: int = 128,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels, attention_levels, head_channels, res_blocks = _unet_config(
            num_channels, attention_levels, num_head_channels, num_res_blocks, norm_num_groups,
            with_conditioning, cross_attention_dim,
        )
        self.spatial_dims = spatial_dims
        self.label_nc = label_nc
        self.num_channels = num_channels
        self.num_class_embeds = num_class_embeds
        self.with_conditioning = with_conditioning
        self.dtype = dtype

        time_embed_dim = num_channels[0] * 4
        self.time_embed, class_embedding = _time_embedding(num_channels[0], num_class_embeds,
                                                           dtype)
        if class_embedding is not None:
            self.class_embedding = class_embedding
        self.conv_in = ConvND(spatial_dims, in_channels, num_channels[0], 3, padding=1,
                              dtype=dtype)
        common = dict(
            spatial_dims=spatial_dims, temb_channels=time_embed_dim,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            transformer_num_layers=transformer_num_layers,
            cross_attention_dim=cross_attention_dim, upcast_attention=upcast_attention,
            use_flash_attention=use_flash_attention, dtype=dtype,
        )
        down_blocks = []
        output_channel = num_channels[0]
        for i in range(len(num_channels)):
            input_channel = output_channel
            output_channel = num_channels[i]
            down_blocks.append(DownBlock(
                in_channels=input_channel, out_channels=output_channel,
                num_res_blocks=res_blocks[i], add_downsample=i < len(num_channels) - 1,
                resblock_updown=resblock_updown,
                with_attn=attention_levels[i] and not with_conditioning,
                with_cross_attn=attention_levels[i] and with_conditioning,
                num_head_channels=head_channels[i], **common,
            ))
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
            up_blocks.append(SPADEUpBlock(
                in_channels=input_channel, prev_output_channel=prev_output_channel,
                out_channels=output_channel, label_nc=label_nc,
                num_res_blocks=reversed_res_blocks[i] + 1,
                add_upsample=i < len(num_channels) - 1, resblock_updown=resblock_updown,
                with_attn=reversed_attention[i] and not with_conditioning,
                with_cross_attn=reversed_attention[i] and with_conditioning,
                num_head_channels=reversed_heads[i],
                spade_intermediate_channels=spade_intermediate_channels, **common,
            ))
        self.up_blocks = nn.ModuleList(up_blocks)
        self.out = nn.Sequential(
            GroupNorm(norm_num_groups, num_channels[0], norm_eps, dtype=dtype),
            nn.SiLU(),
            ConvND(spatial_dims, num_channels[0], out_channels, 3, padding=1, zero_init=True,
                   dtype=dtype),
        )

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        seg: torch.Tensor,
        context: torch.Tensor | None = None,
        class_labels: torch.Tensor | None = None,
        down_block_additional_residuals: Sequence[torch.Tensor] | None = None,
        mid_block_additional_residual: torch.Tensor | None = None,
    ) -> torch.Tensor:
        _check_context(context, self.with_conditioning)
        if self.dtype is not None:
            x, seg = x.to(self.dtype), seg.to(self.dtype)
        emb = _embed(self, x, timesteps, class_labels)
        h = self.conv_in(x)
        down_block_res_samples = [h]
        for block in self.down_blocks:
            h, res_samples = block(h, emb, context)
            down_block_res_samples.extend(res_samples)
        if down_block_additional_residuals is not None:
            down_block_res_samples = [
                s + r.to(s.dtype)
                for s, r in zip(down_block_res_samples, down_block_additional_residuals)
            ]
        h = self.middle_block(h, emb, context)
        if mid_block_additional_residual is not None:
            h = h + mid_block_additional_residual.to(h.dtype)
        for block in self.up_blocks:
            n_res = len(block.resnets)
            res_samples = down_block_res_samples[-n_res:]
            down_block_res_samples = down_block_res_samples[:-n_res]
            h = block(h, res_samples, emb, seg, context)
        return self.out(h).float()
