"""ControlNet: a zero-initialised control branch for diffusion UNets.

Counterpart of generativemodels_tpu/networks/nets/controlnet.py
(ControlNetConditioningEmbedding, ControlNet, copy_weights_to_controlnet),
channels-first, with the reference's torch state-dict keys
(`controlnet_cond_embedding.{conv_in, blocks.{i}, conv_out}`,
`controlnet_down_blocks.{i}`, `controlnet_mid_block`, and the UNet's
down and mid keys), so that networks/convert.py carries JAX weights over and
a trained UNet's state dict seeds it.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.convolutions import ConvND
from .diffusion_model_unet import (
    DownBlock,
    MidBlock,
    _check_context,
    _embed,
    _time_embedding,
    _unet_config,
)

__all__ = ["ControlNet", "ControlNetConditioningEmbedding", "copy_weights_to_controlnet"]


class ControlNetConditioningEmbedding(nn.Module):
    """Strided-conv encoder projecting the conditioning image to the UNet's
    first feature width; its last conv is zero-initialised."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        num_channels: Sequence[int] = (16, 32, 96, 256),
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = tuple(num_channels)
        self.conv_in = ConvND(spatial_dims, in_channels, num_channels[0], kernel_size=3,
                              padding=1, dtype=dtype)
        blocks = []
        for i in range(len(num_channels) - 1):
            blocks.append(ConvND(spatial_dims, num_channels[i], num_channels[i], kernel_size=3,
                                 padding=1, dtype=dtype))
            blocks.append(ConvND(spatial_dims, num_channels[i], num_channels[i + 1],
                                 kernel_size=3, strides=2, padding=1, dtype=dtype))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = ConvND(spatial_dims, num_channels[-1], out_channels, kernel_size=3,
                               padding=1, zero_init=True, dtype=dtype)

    def forward(self, conditioning: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(conditioning))
        for block in self.blocks:
            h = F.silu(block(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """The UNet's down and mid path, fed the conditioning image's embedding,
    emitting one zero-initialised 1x1 conv of every residual.

    Forward contract, as the JAX module's: ``controlnet(x, timesteps,
    controlnet_cond, conditioning_scale=1.0, context=None,
    class_labels=None)`` returns ``(down_block_res_samples,
    mid_block_res_sample)``, float32 (B, C, *spatial) tensors scaled by
    `conditioning_scale`, ready for DiffusionModelUNet's residual arguments.
    Args mirror the JAX module's; `dtype` is the computation type.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
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
        conditioning_embedding_in_channels: int = 1,
        conditioning_embedding_num_channels: Sequence[int] = (16, 32, 96, 256),
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
        time_embed_dim = num_channels[0] * 4
        self.time_embed, class_embedding = _time_embedding(num_channels[0], num_class_embeds,
                                                           dtype)
        if class_embedding is not None:
            self.class_embedding = class_embedding
        self.conv_in = ConvND(spatial_dims, in_channels, num_channels[0], kernel_size=3,
                              padding=1, dtype=dtype)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            spatial_dims, conditioning_embedding_in_channels, num_channels[0],
            conditioning_embedding_num_channels, dtype=dtype,
        )
        common = dict(
            spatial_dims=spatial_dims, temb_channels=time_embed_dim,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            transformer_num_layers=transformer_num_layers,
            cross_attention_dim=cross_attention_dim, upcast_attention=upcast_attention,
            use_flash_attention=use_flash_attention, dtype=dtype,
        )
        down_blocks = []
        residual_channels = [num_channels[0]]  # the widths of the residuals, in order
        output_channel = num_channels[0]
        for i in range(len(num_channels)):
            input_channel = output_channel
            output_channel = num_channels[i]
            add_downsample = i < len(num_channels) - 1
            down_blocks.append(
                DownBlock(
                    in_channels=input_channel, out_channels=output_channel,
                    num_res_blocks=res_blocks[i], add_downsample=add_downsample,
                    resblock_updown=resblock_updown,
                    with_attn=attention_levels[i] and not with_conditioning,
                    with_cross_attn=attention_levels[i] and with_conditioning,
                    num_head_channels=head_channels[i], **common,
                )
            )
            residual_channels += [output_channel] * (res_blocks[i] + int(add_downsample))
        self.down_blocks = nn.ModuleList(down_blocks)
        self.middle_block = MidBlock(
            in_channels=num_channels[-1], with_conditioning=with_conditioning,
            num_head_channels=head_channels[-1], **common,
        )
        self.controlnet_down_blocks = nn.ModuleList(
            ConvND(spatial_dims, c, c, kernel_size=1, zero_init=True, dtype=dtype)
            for c in residual_channels
        )
        self.controlnet_mid_block = ConvND(spatial_dims, num_channels[-1], num_channels[-1],
                                           kernel_size=1, zero_init=True, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        controlnet_cond: torch.Tensor,
        conditioning_scale: float = 1.0,
        context: torch.Tensor | None = None,
        class_labels: torch.Tensor | None = None,
    ) -> tuple[list[torch.Tensor], torch.Tensor]:
        _check_context(context, self.with_conditioning)
        if self.dtype is not None:
            x = x.to(self.dtype)
            controlnet_cond = controlnet_cond.to(self.dtype)
        emb = _embed(self, x, timesteps, class_labels)
        h = self.conv_in(x) + self.controlnet_cond_embedding(controlnet_cond)
        down_block_res_samples = [h]
        for block in self.down_blocks:
            h, res_samples = block(h, emb, context)
            down_block_res_samples.extend(res_samples)
        h = self.middle_block(h, emb, context)
        controlled = [
            conv(sample).float() * conditioning_scale
            for conv, sample in zip(self.controlnet_down_blocks, down_block_res_samples)
        ]
        return controlled, self.controlnet_mid_block(h).float() * conditioning_scale


def copy_weights_to_controlnet(
    controlnet: nn.Module, diffusion_model: nn.Module, verbose: bool = True
) -> nn.Module:
    """Seed a ControlNet from a DiffusionModelUNet: every parameter whose key
    both state dicts hold with the same shape (time_embed, class_embedding,
    conv_in, down_blocks, middle_block) is copied into `controlnet`, as the
    reference's non-strict `load_state_dict` does. The copies hold their
    own storage, and `diffusion_model` is left as it was. Returns
    `controlnet`."""
    source = diffusion_model.state_dict()
    copied, own = [], []
    with torch.no_grad():
        for key, value in controlnet.state_dict().items():
            src = source.get(key)
            if src is not None and src.shape == value.shape:
                value.copy_(src)
                copied.append(key)
            else:
                own.append(key)
    if verbose:
        print(
            f"Copied weights from {len(copied)} keys of the diffusion model into the "
            f"ControlNet. ControlNet-only keys: {len(own)}"
        )
    return controlnet
