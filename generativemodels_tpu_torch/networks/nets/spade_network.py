"""SPADE VAE-GAN for semantic image synthesis, channels-first.

Counterpart of generativemodels_tpu/networks/nets/spade_network.py:
`SPADENet` (VAE or GAN mode), `SPADENetEncoder`, `SPADENetDecoder`,
`SPADENetResNetBlock`, `kld_loss` and `reparameterize` (its noise from a
`torch.Generator`, where JAX takes a key). Keys as the reference's:
`encoder.blocks.{i}`, `encoder.fc_mu/fc_var`, `decoder.fc`,
`decoder.blocks.{i}` (norm_0/norm_1/norm_s, conv_0/conv_1/conv_s) and
`decoder.last_conv`; the flat latent is (C, *spatial), as the reference
flattens it (networks/convert.py permutes the JAX module's (*spatial, C)).

In GAN mode the decoder maps the resized segmentation's channels to the
first width with a Linear over the channel axis, as the JAX module does (the
reference's GAN-mode fc cannot run). The decoder's "bilinear" upsampling is
torch's linear mode at scale 2 with align_corners=False, which
`jax.image.resize`'s linear equals when upsampling; its "bicubic" is JAX's
Keys cubic (a = -0.5, edge weights renormalised), built here from the same
per-axis weight matrices.
"""
from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.convolutions import ConvND, upsample_nearest
from ..blocks.spade_norm import SPADE, instance_norm, resize_nearest

__all__ = ["SPADENet", "SPADENetEncoder", "SPADENetDecoder", "SPADENetResNetBlock", "kld_loss",
           "reparameterize"]

_LINEAR = {1: "linear", 2: "bilinear", 3: "trilinear"}


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, 1)), summed."""
    return -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar))


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """mu + eps * exp(logvar / 2), eps drawn from `generator`."""
    std = torch.exp(0.5 * logvar)
    eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
    return eps * std + mu


def _act(act):
    if act is None:
        return lambda x: x
    if isinstance(act, (tuple, list)):
        name, kw = act[0], act[1] if len(act) > 1 else {}
    else:
        name, kw = act, {}
    name = str(name).upper()
    if name == "LEAKYRELU":
        return lambda x: F.leaky_relu(x, kw.get("negative_slope", 0.01))
    if name == "RELU":
        return F.relu
    if name == "TANH":
        return torch.tanh
    if name == "SIGMOID":
        return torch.sigmoid
    raise ValueError(f"Unsupported activation {act}")


def _keys_cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of `jax.image.resize(method="cubic")` on one axis,
    upsampling (no antialias widening)."""
    sample = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None])
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, ((1.5 * x - 2.5) * x) * x + 1.0)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def _upsample2(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "nearest":
        return upsample_nearest(x, 2)
    if mode == "bilinear":
        return F.interpolate(x, scale_factor=2, mode=_LINEAR[x.ndim - 2], align_corners=False)
    for axis in range(2, x.ndim):  # bicubic: one weight matrix an axis
        w = torch.from_numpy(_keys_cubic_weights(x.shape[axis], 2 * x.shape[axis]))
        x = torch.movedim(torch.tensordot(x, w.to(x), dims=([axis], [0])), -1, axis)
    return x


class SPADENetResNetBlock(nn.Module):
    """SPADE-normalised residual block, with a learned shortcut (norm_s,
    conv_s) when the width changes."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        label_nc: int,
        spade_intermediate_channels: int = 128,
        norm: str = "INSTANCE",
        kernel_size: int = 3,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        int_channels = min(in_channels, out_channels)
        pad = (kernel_size - 1) // 2

        def spade(nc):
            return SPADE(label_nc, nc, kernel_size=kernel_size, spatial_dims=spatial_dims,
                         hidden_channels=spade_intermediate_channels, norm=norm, dtype=dtype)

        self.learned_shortcut = in_channels != out_channels
        if self.learned_shortcut:
            self.norm_s = spade(in_channels)
            self.conv_s = ConvND(spatial_dims, in_channels, out_channels, 1, dtype=dtype)
        self.norm_0 = spade(in_channels)
        self.conv_0 = ConvND(spatial_dims, in_channels, int_channels, kernel_size, padding=pad,
                             dtype=dtype)
        self.norm_1 = spade(int_channels)
        self.conv_1 = ConvND(spatial_dims, int_channels, out_channels, kernel_size, padding=pad,
                             dtype=dtype)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x_s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return x_s + dx


class SPADENetEncoder(nn.Module):
    """Strided-conv VAE encoder: image (B, C, *spatial) -> (mu, logvar), (B, z_dim) each."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        z_dim: int,
        num_channels: Sequence[int],
        input_shape: Sequence[int],
        kernel_size: int = 3,
        norm: str = "INSTANCE",
        act: str | tuple = ("LEAKYRELU", {"negative_slope": 0.2}),
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = tuple(num_channels)
        if len(input_shape) != spatial_dims:
            raise ValueError("Length of parameter input shape must match spatial_dims")
        for s in input_shape:
            if s % (2 ** len(num_channels)) != 0:
                raise ValueError(
                    "Each dimension of your input must be divisible by 2 ** (autoencoder depth)."
                )
        pad = (kernel_size - 1) // 2
        chans = (in_channels,) + num_channels
        self.blocks = nn.ModuleList(
            ConvND(spatial_dims, chans[i], chans[i + 1], kernel_size, strides=2, padding=pad,
                   dtype=dtype)
            for i in range(len(num_channels))
        )
        self.act = _act(act)
        flat = num_channels[-1] * math.prod(s // 2 ** len(num_channels) for s in input_shape)
        self.fc_mu = nn.Linear(flat, z_dim)
        self.fc_var = nn.Linear(flat, z_dim)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = x
        for block in self.blocks:
            h = self.act(instance_norm(block(h)))
        h = h.reshape(h.shape[0], -1).float()
        return self.fc_mu(h), self.fc_var(h)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        mu, logvar = self(x)
        return reparameterize(mu, logvar, generator)


class SPADENetDecoder(nn.Module):
    """SPADE ResNet decoder with x2 upsampling after each block;
    `num_channels` coarse to fine."""

    def __init__(
        self,
        spatial_dims: int,
        out_channels: int,
        label_nc: int,
        input_shape: Sequence[int],
        num_channels: Sequence[int],
        z_dim: int | None = None,
        is_gan: bool = False,
        spade_intermediate_channels: int = 128,
        norm: str = "INSTANCE",
        act: str | tuple = ("LEAKYRELU", {"negative_slope": 0.2}),
        last_act: str | tuple | None = ("LEAKYRELU", {"negative_slope": 0.2}),
        kernel_size: int = 3,
        upsampling_mode: str = "nearest",
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = list(num_channels)
        if upsampling_mode not in ("nearest", "bilinear", "bicubic"):
            raise ValueError(f"Unsupported upsampling mode {upsampling_mode}")
        self.is_gan = is_gan
        self.num_channels0 = num_channels[0]
        self.latent_spatial = tuple(s // (2 ** len(num_channels)) for s in input_shape)
        self.upsampling_mode = upsampling_mode
        self.dtype = dtype
        if is_gan:
            self.fc = nn.Linear(label_nc, num_channels[0])
        else:
            self.fc = nn.Linear(z_dim, math.prod(self.latent_spatial) * num_channels[0])
        path = num_channels + [out_channels]
        self.blocks = nn.ModuleList(
            SPADENetResNetBlock(spatial_dims, path[i], path[i + 1], label_nc,
                                spade_intermediate_channels, norm, kernel_size, dtype=dtype)
            for i in range(len(path) - 1)
        )
        self.last_conv = ConvND(spatial_dims, out_channels, out_channels, kernel_size,
                                padding=(kernel_size - 1) // 2, dtype=dtype)
        self.last_act = _act(last_act)

    def forward(self, seg: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        if self.is_gan:
            small = resize_nearest(seg, self.latent_spatial)
            x = self.fc(small.movedim(1, -1)).movedim(-1, 1)
        else:
            x = self.fc(z).reshape(z.shape[0], self.num_channels0, *self.latent_spatial)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for block in self.blocks:
            x = _upsample2(block(x, seg), self.upsampling_mode)
        return self.last_act(self.last_conv(x)).float()


class SPADENet(nn.Module):
    """SPADE semantic-image-synthesis network.

    `forward(seg, x, generator)` returns (image, kld_loss) in VAE mode and
    (image,) in GAN mode; `encode(x, generator)` draws a latent and
    `decode(seg, z)` synthesises. Arguments mirror the JAX module's.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        label_nc: int,
        input_shape: Sequence[int],
        num_channels: Sequence[int],
        z_dim: int | None = None,
        is_vae: bool = True,
        spade_intermediate_channels: int = 128,
        norm: str = "INSTANCE",
        act: str | tuple = ("LEAKYRELU", {"negative_slope": 0.2}),
        last_act: str | tuple | None = ("LEAKYRELU", {"negative_slope": 0.2}),
        kernel_size: int = 3,
        upsampling_mode: str = "nearest",
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        if is_vae and z_dim is None:
            raise ValueError("z_dim cannot be None when is_vae is True.")
        self.is_vae = is_vae
        self.label_nc = label_nc
        if is_vae:
            self.encoder = SPADENetEncoder(spatial_dims, in_channels, z_dim, num_channels,
                                           input_shape, kernel_size, norm, act, dtype=dtype)
        self.decoder = SPADENetDecoder(
            spatial_dims, out_channels, label_nc, input_shape, tuple(reversed(tuple(num_channels))),
            z_dim, not is_vae, spade_intermediate_channels, norm, act, last_act, kernel_size,
            upsampling_mode, dtype=dtype,
        )

    def forward(self, seg: torch.Tensor, x: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        if self.is_vae:
            z_mu, z_logvar = self.encoder(x)
            z = reparameterize(z_mu, z_logvar, generator)
            return self.decoder(seg, z), kld_loss(z_mu, z_logvar)
        return (self.decoder(seg, None),)

    def encode(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.encoder.encode(x, generator)

    def decode(self, seg: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        return self.decoder(seg, z)
