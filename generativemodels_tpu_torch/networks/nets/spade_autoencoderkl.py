"""SPADE-conditioned AutoencoderKL (a decoder conditioned on a segmentation map).

Counterpart of generativemodels_tpu/networks/nets/spade_autoencoderkl.py:
`SPADEAEKLResBlock`, `SPADEAEKLDecoder` and `SPADEAutoencoderKL`. The
encoder is the port's `AEKLEncoder`; the decoder keeps the plain decoder's
flat `decoder.blocks.{i}` order with SPADE res blocks in place of the plain
ones, so the reference's keys hold. The SPADE base norm is a
parameter-free GroupNorm at torch's default eps 1e-5 (the reference passes
`affine=False` and no eps), whatever `norm_eps`.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.convolutions import ConvND
from ..blocks.layers import GroupNorm
from ..blocks.spade_norm import SPADE
from .autoencoderkl import AEKLEncoder, _attention, _Upsample
from .diffusion_model_unet import ensure_tuple_rep

__all__ = ["SPADEAutoencoderKL", "SPADEAEKLDecoder", "SPADEAEKLResBlock"]


class SPADEAEKLResBlock(nn.Module):
    """The AEKL res block with SPADE(GROUP) norms conditioned on `seg`."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        norm_num_groups: int,
        norm_eps: float,
        out_channels: int | None,
        label_nc: int,
        spade_intermediate_channels: int = 128,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        out_channels = out_channels or in_channels

        def spade(nc):
            return SPADE(
                label_nc, nc, kernel_size=3, spatial_dims=spatial_dims,
                hidden_channels=spade_intermediate_channels, norm="GROUP",
                norm_params={"num_groups": norm_num_groups, "affine": False}, dtype=dtype,
            )

        self.norm1 = spade(in_channels)
        self.conv1 = ConvND(spatial_dims, in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = spade(out_channels)
        self.conv2 = ConvND(spatial_dims, out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.nin_shortcut = (
            ConvND(spatial_dims, in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x, seg)))
        h = self.conv2(F.silu(self.norm2(h, seg)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class SPADEAEKLDecoder(nn.Module):
    """The AEKL decoder with SPADE res blocks; `blocks` in the plain
    decoder's order (conv_in; the nonlocal trio; per level, deepest first,
    res blocks with their attention and an upsampler; norm_out; conv_out)."""

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
        label_nc: int,
        with_nonlocal_attn: bool = True,
        use_flash_attention: bool | None = None,
        spade_intermediate_channels: int = 128,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        reversed_channels = list(reversed(tuple(num_channels)))
        reversed_attention = list(reversed(tuple(attention_levels)))
        reversed_res_blocks = list(reversed(tuple(num_res_blocks)))
        attn = (norm_num_groups, norm_eps, use_flash_attention, dtype)

        def res(c_in, c_out):
            return SPADEAEKLResBlock(spatial_dims, c_in, norm_num_groups, norm_eps, c_out,
                                     label_nc, spade_intermediate_channels, dtype=dtype)

        c0 = reversed_channels[0]
        blocks: list[nn.Module] = [ConvND(spatial_dims, in_channels, c0, 3, padding=1, dtype=dtype)]
        if with_nonlocal_attn:
            blocks += [res(c0, c0), _attention(spatial_dims, c0, *attn), res(c0, c0)]
        block_out_ch = c0
        for i in range(len(reversed_channels)):
            block_in_ch = block_out_ch
            block_out_ch = reversed_channels[i]
            for _ in range(reversed_res_blocks[i]):
                blocks.append(res(block_in_ch, block_out_ch))
                block_in_ch = block_out_ch
                if reversed_attention[i]:
                    blocks.append(_attention(spatial_dims, block_in_ch, *attn))
            if i != len(reversed_channels) - 1:
                blocks.append(_Upsample(spatial_dims, block_in_ch, False, dtype=dtype))
        blocks += [
            GroupNorm(norm_num_groups, block_in_ch, norm_eps, dtype=dtype),
            ConvND(spatial_dims, block_in_ch, out_channels, 3, padding=1, dtype=dtype),
        ]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, seg) if isinstance(block, SPADEAEKLResBlock) else block(x)
        return x


class SPADEAutoencoderKL(nn.Module):
    """AutoencoderKL whose decoder is SPADE-conditioned on a segmentation map.

    The methods of the port's `AutoencoderKL`, with `seg` (B, label_nc,
    *spatial) where the decoder runs: `encode`, `sampling`,
    `reconstruct(x, seg)`, `decode(z, seg)`, `forward(x, seg, generator)`,
    `encode_stage_2_inputs`, `decode_stage_2_outputs(z, seg)`. `label_nc`
    is read by the latent inferers. Arguments mirror the JAX module's.
    """

    def __init__(
        self,
        spatial_dims: int,
        label_nc: int,
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
        spade_intermediate_channels: int = 128,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = tuple(num_channels)
        attention_levels = tuple(attention_levels)
        if any((c % norm_num_groups) != 0 for c in num_channels):
            raise ValueError(
                "SPADEAutoencoderKL expects all num_channels being multiple of norm_num_groups"
            )
        if len(num_channels) != len(attention_levels):
            raise ValueError(
                "SPADEAutoencoderKL expects num_channels being same size of attention_levels"
            )
        num_res_blocks = ensure_tuple_rep(num_res_blocks, len(num_channels))
        self.label_nc = label_nc
        self.dtype = dtype
        common = dict(
            spatial_dims=spatial_dims, num_channels=num_channels, num_res_blocks=num_res_blocks,
            norm_num_groups=norm_num_groups, norm_eps=norm_eps,
            attention_levels=attention_levels, use_flash_attention=use_flash_attention,
            dtype=dtype,
        )
        self.encoder = AEKLEncoder(in_channels=in_channels, out_channels=latent_channels,
                                   with_nonlocal_attn=with_encoder_nonlocal_attn, **common)
        self.decoder = SPADEAEKLDecoder(
            in_channels=latent_channels, out_channels=out_channels, label_nc=label_nc,
            with_nonlocal_attn=with_decoder_nonlocal_attn,
            spade_intermediate_channels=spade_intermediate_channels, **common,
        )

        def quant_conv():
            return ConvND(spatial_dims, latent_channels, latent_channels, 1, dtype=dtype)

        self.quant_conv_mu = quant_conv()
        self.quant_conv_log_sigma = quant_conv()
        self.post_quant_conv = quant_conv()

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) if self.dtype is not None else x

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.encoder(self._in(x))
        z_mu = self.quant_conv_mu(h)
        z_log_var = torch.clamp(self.quant_conv_log_sigma(h), -30.0, 20.0)
        return z_mu.float(), torch.exp(z_log_var / 2).float()

    def sampling(self, z_mu: torch.Tensor, z_sigma: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        eps = torch.randn(z_sigma.shape, generator=generator, device=z_sigma.device,
                          dtype=z_sigma.dtype)
        return z_mu + eps * z_sigma

    def reconstruct(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x)[0], seg)

    def decode(self, z: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        h = self.post_quant_conv(self._in(z))
        return self.decoder(h, self._in(seg)).float()

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                generator: torch.Generator | None = None):
        z_mu, z_sigma = self.encode(x)
        z = self.sampling(z_mu, z_sigma, generator=generator)
        return self.decode(z, seg), z_mu, z_sigma

    def encode_stage_2_inputs(self, x: torch.Tensor,
                              generator: torch.Generator | None = None) -> torch.Tensor:
        z_mu, z_sigma = self.encode(x)
        return self.sampling(z_mu, z_sigma, generator=generator)

    def decode_stage_2_outputs(self, z: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        return self.decode(z, seg)
