"""Diffusion autoencoder: a semantic encoder conditions the UNet.

Counterpart of generativemodels_tpu/recipes/diffusion_autoencoder.py (the
reference's 2d_diffusion_autoencoder tutorial): a semantic encoder maps the
clean image to an embedding that conditions the diffusion UNet through
cross-attention; at inference the embedding of an input image steers its
reconstruction. `SemanticEncoder` stands in for the tutorial's ResNet18;
its weights cross from JAX by
`networks/convert.py::semantic_encoder_state_dict_from_jax`.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F
from torch import nn

from ..networks.blocks.convolutions import ConvND
from ..networks.blocks.layers import GroupNorm, Linear
from ..networks.schedulers import DDPMScheduler
from .draws import Draws


class SemanticEncoder(nn.Module):
    """Small conv encoder producing a (B, 1, emb_dim) cross-attention context:
    per width a stride-2 3x3 conv, GroupNorm (min(8, width) groups) and
    SiLU, then a global average pool and a linear head.

    Args:
        spatial_dims, in_channels: the image's (JAX reads them off x).
        emb_dim: embedding width.
        widths: the convs' output channels.
        dtype: computation type of the convs and norms (the head computes
            in float32, as the JAX head has no dtype).
    """

    def __init__(self, spatial_dims: int = 2, in_channels: int = 1, emb_dim: int = 64,
                 widths: tuple[int, ...] = (32, 64, 128),
                 dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.widths = tuple(widths)
        chans = (in_channels,) + self.widths
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", ConvND(spatial_dims, chans[i], w, 3, 2, 1, dtype=dtype))
            self.add_module(f"norm{i}", GroupNorm(min(8, w), w, dtype=dtype))
        self.head = Linear(self.widths[-1], emb_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(len(self.widths)):
            h = F.silu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h)))
        h = h.mean(dim=tuple(range(2, h.ndim)))  # global average pool
        return self.head(h)[:, None, :]


def diffusion_autoencoder_loss(
    unet_apply,
    encoder_apply,
    scheduler,
    images: torch.Tensor,
    generator: torch.Generator | None = None,
    num_train_timesteps: int = 1000,
    noise: torch.Tensor | None = None,
    timesteps: torch.Tensor | None = None,
) -> torch.Tensor:
    """One training loss: the UNet conditioned on the images' semantic code.

    Draws the noise, then the timesteps, from `generator` unless given.
    """
    if generator is None and (noise is None or timesteps is None):
        generator = torch.Generator(images.device).manual_seed(0)
    if noise is None:
        noise = torch.randn(images.shape, generator=generator, device=images.device,
                            dtype=images.dtype)
    if timesteps is None:
        timesteps = torch.randint(0, num_train_timesteps, (images.shape[0],),
                                  generator=generator, device=images.device)
    context = encoder_apply(images)
    noisy = scheduler.add_noise(images, noise, timesteps)
    pred = unet_apply(noisy, timesteps, context)
    return torch.mean((pred - noise) ** 2)


def reconstruct(
    unet_apply,
    encoder_apply,
    scheduler,
    images: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: Iterable[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Encode images semantically and regenerate them from noise.

    `noise` gives the draws in their order, in place of `generator`'s: the
    initial sample, then a DDPM step's noise at each step.
    """
    draws = Draws(images.device, generator, noise)
    context = encoder_apply(images)
    x = draws.normal(images.shape, images.dtype)
    is_ddpm = isinstance(scheduler, DDPMScheduler)
    for t in scheduler.timesteps:
        pred = unet_apply(x, t.expand(images.shape[0]), context)
        if is_ddpm:
            x, _ = scheduler.step(pred, t, x, noise=draws.normal(pred.shape, pred.dtype))
        else:
            x, _ = scheduler.step(pred, t, x)
    return x
