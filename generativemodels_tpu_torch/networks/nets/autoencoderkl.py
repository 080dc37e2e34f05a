"""KL-regularised autoencoder (the latent-diffusion stage 1), channels-first.

Counterpart of generativemodels_tpu/networks/nets/autoencoderkl.py:
`AEKLResBlock`, `_Downsample` (a (0, 1) pad on every spatial axis, then a
stride-2 valid conv), `_Upsample` (nearest x2 then a 3x3 conv, or a
transposed conv), `AEKLEncoder`, `AEKLDecoder` and `AutoencoderKL`. The
encoder and decoder keep their layers in one `blocks` list in the
reference's append order, so the state-dict keys are the reference torch
keys (`encoder.blocks.{i}...`, `decoder.blocks.{i}...`) and
networks/convert.py maps JAX parameters onto them.

`dtype` mirrors the JAX module's mixed precision: parameters stay float32,
the input is cast to `dtype` on entry, every layer computes in it (GroupNorm
statistics in float32) and the outputs are cast to float32 on exit. So in
bf16 the log-variance clip and `exp(log_var / 2)` run in bf16, before that
cast. `use_checkpointing` recomputes the encoder and the decoder in the
backward (`torch.utils.checkpoint`, where JAX uses `nn.remat`).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import draw_local
from ...parallel.spatial import current_spatial_cut
from ..blocks.attention_blocks import AttentionBlock
from ..blocks.convolutions import ConvND, ConvTransposeND
from ..blocks.layers import GroupNorm
from .diffusion_model_unet import _run_block, ensure_tuple_rep

__all__ = ["AutoencoderKL", "AEKLEncoder", "AEKLDecoder", "AEKLResBlock"]


class AEKLResBlock(nn.Module):
    """norm -> silu -> conv, twice, with a 1x1 shortcut on a channel change."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        norm_num_groups: int,
        norm_eps: float,
        out_channels: int | None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(norm_num_groups, in_channels, norm_eps, dtype=dtype)
        self.conv1 = ConvND(spatial_dims, in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(norm_num_groups, out_channels, norm_eps, dtype=dtype)
        self.conv2 = ConvND(spatial_dims, out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (
            ConvND(spatial_dims, in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _Downsample(nn.Module):
    """A (0, 1) pad on every spatial axis, then a stride-2 valid 3x3 conv."""

    def __init__(self, spatial_dims: int, in_channels: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.spatial_dims = spatial_dims
        self.conv = ConvND(spatial_dims, in_channels, in_channels, 3, strides=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.pad lists the last axis first: (0, 1) on each spatial axis, none on channels
        if current_spatial_cut() is None:
            return self.conv(F.pad(x, (0, 1) * self.spatial_dims))
        # the cut axis (the first spatial one, F.pad's last pair) takes its
        # pad plane at the outer border only, from the conv's halo
        return self.conv(F.pad(x, (0, 1) * (self.spatial_dims - 1) + (0, 0)), cut_pad_after=1)


class _Upsample(nn.Module):
    """Nearest x2 then a 3x3 conv, or a stride-2 transposed conv."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        use_convtranspose: bool,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        if use_convtranspose:
            self.conv = ConvTransposeND(
                spatial_dims, in_channels, in_channels, 3, strides=2, padding=1,
                output_padding=1, dtype=dtype,
            )
        else:
            self.conv = ConvND(
                spatial_dims, in_channels, in_channels, 3, padding=1, nearest_upsample=True,
                dtype=dtype,
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _attention(spatial_dims, channels, norm_num_groups, norm_eps, use_flash_attention, dtype):
    """The AEKL's attention block: one head of full width."""
    return AttentionBlock(
        spatial_dims, channels, norm_num_groups=norm_num_groups, norm_eps=norm_eps,
        use_flash_attention=use_flash_attention, dtype=dtype,
    )


class AEKLEncoder(nn.Module):
    """Conv cascade down to the spatial latent.

    `blocks`, in order: conv_in; per level, its res blocks (each followed by
    an attention block on attention levels) and, but on the last level, a
    downsampler; the nonlocal res-attention-res trio; norm_out; conv_out.
    No SiLU between norm_out and conv_out, as in the reference.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        num_channels: Sequence[int],
        out_channels: int,
        num_res_blocks: Sequence[int],
        norm_num_groups: int,
        norm_eps: float,
        attention_levels: Sequence[bool],
        with_nonlocal_attn: bool = True,
        use_flash_attention: bool | None = None,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = tuple(num_channels)
        norm = (norm_num_groups, norm_eps)
        attn = (norm_num_groups, norm_eps, use_flash_attention, dtype)
        blocks: list[nn.Module] = [
            ConvND(spatial_dims, in_channels, num_channels[0], 3, padding=1, dtype=dtype)
        ]
        output_channel = num_channels[0]
        for i in range(len(num_channels)):
            input_channel = output_channel
            output_channel = num_channels[i]
            for _ in range(num_res_blocks[i]):
                blocks.append(
                    AEKLResBlock(spatial_dims, input_channel, *norm, output_channel, dtype=dtype)
                )
                input_channel = output_channel
                if attention_levels[i]:
                    blocks.append(_attention(spatial_dims, input_channel, *attn))
            if i != len(num_channels) - 1:
                blocks.append(_Downsample(spatial_dims, input_channel, dtype=dtype))
        if with_nonlocal_attn:
            c = num_channels[-1]
            blocks += [
                AEKLResBlock(spatial_dims, c, *norm, c, dtype=dtype),
                _attention(spatial_dims, c, *attn),
                AEKLResBlock(spatial_dims, c, *norm, c, dtype=dtype),
            ]
        blocks += [
            GroupNorm(norm_num_groups, num_channels[-1], norm_eps, dtype=dtype),
            ConvND(spatial_dims, num_channels[-1], out_channels, 3, padding=1, dtype=dtype),
        ]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class AEKLDecoder(nn.Module):
    """Conv cascade up from the latent to image space.

    `blocks`, in order: conv_in; the nonlocal res-attention-res trio; per
    level, deepest first, its res blocks (each followed by an attention
    block on attention levels) and, but on the last level, an upsampler;
    norm_out; conv_out.
    """

    def __init__(
        self,
        spatial_dims: int,
        num_channels: Sequence[int],
        in_channels: int,
        out_channels: int,
        num_res_blocks: Sequence[int],
        norm_num_groups: int,
        norm_eps: float,
        attention_levels: Sequence[bool],
        with_nonlocal_attn: bool = True,
        use_flash_attention: bool | None = None,
        use_convtranspose: bool = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        reversed_channels = list(reversed(tuple(num_channels)))
        reversed_attention = list(reversed(tuple(attention_levels)))
        reversed_res_blocks = list(reversed(tuple(num_res_blocks)))
        norm = (norm_num_groups, norm_eps)
        attn = (norm_num_groups, norm_eps, use_flash_attention, dtype)
        c0 = reversed_channels[0]
        blocks: list[nn.Module] = [
            ConvND(spatial_dims, in_channels, c0, 3, padding=1, dtype=dtype)
        ]
        if with_nonlocal_attn:
            blocks += [
                AEKLResBlock(spatial_dims, c0, *norm, c0, dtype=dtype),
                _attention(spatial_dims, c0, *attn),
                AEKLResBlock(spatial_dims, c0, *norm, c0, dtype=dtype),
            ]
        block_out_ch = c0
        for i in range(len(reversed_channels)):
            block_in_ch = block_out_ch
            block_out_ch = reversed_channels[i]
            for _ in range(reversed_res_blocks[i]):
                blocks.append(
                    AEKLResBlock(spatial_dims, block_in_ch, *norm, block_out_ch, dtype=dtype)
                )
                block_in_ch = block_out_ch
                if reversed_attention[i]:
                    blocks.append(_attention(spatial_dims, block_in_ch, *attn))
            if i != len(reversed_channels) - 1:
                blocks.append(
                    _Upsample(spatial_dims, block_in_ch, use_convtranspose, dtype=dtype)
                )
        blocks += [
            GroupNorm(norm_num_groups, block_in_ch, norm_eps, dtype=dtype),
            ConvND(spatial_dims, block_in_ch, out_channels, 3, padding=1, dtype=dtype),
        ]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class AutoencoderKL(nn.Module):
    """VAE with a KL-regularised latent space (the LDM stage 1).

    The public methods take and return (B, C, *spatial) tensors: `encode`
    gives (z_mu, z_sigma), `sampling` draws z = z_mu + eps * z_sigma with eps
    from `generator` (torch's default generator when None), `decode`,
    `reconstruct` (the decode of z_mu), `forward` (reconstruction, z_mu,
    z_sigma), and the stage-2 pair `encode_stage_2_inputs` (a sampled z) and
    `decode_stage_2_outputs`. Arguments mirror the JAX module's.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int = 1,
        out_channels: int = 1,
        num_res_blocks: Sequence[int] | int = (2, 2, 2, 2),
        num_channels: Sequence[int] = (32, 64, 64, 64),
        attention_levels: Sequence[bool] = (False, False, True, True),
        latent_channels: int = 3,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        with_encoder_nonlocal_attn: bool = True,
        with_decoder_nonlocal_attn: bool = True,
        use_flash_attention: bool | None = None,
        use_checkpointing: bool = False,
        use_convtranspose: bool = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = tuple(num_channels)
        attention_levels = tuple(attention_levels)
        if any((c % norm_num_groups) != 0 for c in num_channels):
            raise ValueError(
                "AutoencoderKL expects all num_channels being multiple of norm_num_groups"
            )
        if len(num_channels) != len(attention_levels):
            raise ValueError(
                "AutoencoderKL expects num_channels being same size of attention_levels"
            )
        num_res_blocks = ensure_tuple_rep(num_res_blocks, len(num_channels))
        self.use_checkpointing = use_checkpointing
        self.dtype = dtype
        common = dict(
            spatial_dims=spatial_dims, num_channels=num_channels, num_res_blocks=num_res_blocks,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            attention_levels=attention_levels, use_flash_attention=use_flash_attention,
            dtype=dtype,
        )
        self.encoder = AEKLEncoder(
            in_channels=in_channels, out_channels=latent_channels,
            with_nonlocal_attn=with_encoder_nonlocal_attn, **common,
        )
        self.decoder = AEKLDecoder(
            in_channels=latent_channels, out_channels=out_channels,
            with_nonlocal_attn=with_decoder_nonlocal_attn, use_convtranspose=use_convtranspose,
            **common,
        )

        def quant_conv():
            return ConvND(spatial_dims, latent_channels, latent_channels, 1, dtype=dtype)

        self.quant_conv_mu = quant_conv()
        self.quant_conv_log_sigma = quant_conv()
        self.post_quant_conv = quant_conv()

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) if self.dtype is not None else x

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Image -> (z_mu, z_sigma), each (B, latent_channels, *latent_spatial), float32."""
        h = _run_block(self.use_checkpointing, self.encoder, self._in(x))
        z_mu = self.quant_conv_mu(h)
        z_log_var = torch.clamp(self.quant_conv_log_sigma(h), -30.0, 20.0)
        z_sigma = torch.exp(z_log_var / 2)
        return z_mu.float(), z_sigma.float()

    def sampling(
        self, z_mu: torch.Tensor, z_sigma: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Reparameterised gaussian sample z = mu + eps * sigma. While a mesh
        is current, eps is this rank's rows and slab of the global batch's
        draw (`parallel.mesh.draw_local`)."""
        eps = draw_local(lambda shape: torch.randn(
            shape, generator=generator, device=z_sigma.device, dtype=z_sigma.dtype
        ), z_sigma.shape)
        return z_mu + eps * z_sigma

    def reconstruct(self, x: torch.Tensor) -> torch.Tensor:
        z_mu, _ = self.encode(x)
        return self.decode(z_mu)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.post_quant_conv(self._in(z))
        return _run_block(self.use_checkpointing, self.decoder, h).float()

    def forward(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        z_mu, z_sigma = self.encode(x)
        z = self.sampling(z_mu, z_sigma, generator=generator)
        return self.decode(z), z_mu, z_sigma

    def encode_stage_2_inputs(
        self, x: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        z_mu, z_sigma = self.encode(x)
        return self.sampling(z_mu, z_sigma, generator=generator)

    def decode_stage_2_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)
