"""Conditioned brain-LDM sampling (the model-zoo bundle's sampler).

Counterpart of generativemodels_tpu/recipes/brain_ldm_sampler.py: a 3D
latent diffusion model sampled with its scalar covariates (gender, age,
ventricular and brain volume) as a (B, 1, 4) cross-attention context, the
latent decoded by the 3D AutoencoderKL. The caller builds the networks
with `brain_unet` and `brain_autoencoder`, which resolve them from the
`brain_3d_ldm` preset (`config.load_preset`).

As the JAX recipe, the UNet takes `in_channels` 3 and sees the covariates
only through cross-attention; the preset's `in_channels: 7` (the bundle
also concatenates them into the input) is not what the JAX sampler runs.
"""
from __future__ import annotations

import torch

from ..config import load_preset
from ..inferers import LatentDiffusionInferer
from ..networks.nets import AutoencoderKL, DiffusionModelUNet


def make_conditioning(
    gender: float, age: float, ventricular_vol: float, brain_vol: float, batch: int = 1,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Pack normalised covariates into a (B, 1, 4) float32 context on
    `device` (the card unless the caller asks for the CPU)."""
    vec = torch.tensor([gender, age, ventricular_vol, brain_vol], dtype=torch.float32,
                       device=device)
    return vec.reshape(1, 1, 4).expand(batch, 1, 4)


def brain_unet(dtype: torch.dtype | None = None, **overrides) -> DiffusionModelUNet:
    """The bundle's UNet: the preset's network with the JAX recipe's 3 input
    channels (`recipes/eval_brain_ldm.py:113-118`); `overrides` narrow it
    for tests."""
    return _from_preset("network", dict(in_channels=3, dtype=dtype, **overrides))


def brain_autoencoder(dtype: torch.dtype | None = None, **overrides) -> AutoencoderKL:
    """The bundle's stage 1: the preset's AEKL (64, 128, 128, 128), two res
    blocks a level, no attention, 3 latent channels, checkpointed blocks
    (which only a backward reads)."""
    return _from_preset("autoencoder", dict(dtype=dtype, **overrides))


def _from_preset(name: str, fields: dict):
    """The `brain_3d_ldm` preset's node `name`, built with `fields` merged in
    (the JAX recipe clones the flax module with them)."""
    preset = load_preset("brain_3d_ldm")
    preset.update({name: dict(preset.config[name], **fields)})
    return preset.resolve(name)


def sample_brain_ldm(
    diffusion_model,
    autoencoder_model,
    scheduler,
    latent_shape: tuple,
    gender: float = 0.0,
    age: float = 0.5,
    ventricular_vol: float = 0.5,
    brain_vol: float = 0.5,
    scale_factor: float = 1.0,
    num_inference_steps: int = 50,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cuda",
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample a batch of brain volumes conditioned on the covariates.

    The latent noise is `noise` if given (the sample then runs on its
    device), else drawn from `generator` (one seeded with 0 by default) on
    `device`, the card unless the caller asks for the CPU; the same
    generator then drives any stochastic step. Returns the decoded
    (B, 1, *spatial) volume.
    """
    if noise is None:
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        noise = torch.randn(latent_shape, generator=generator, device=device)
    scheduler.set_timesteps(num_inference_steps, device=noise.device)
    inferer = LatentDiffusionInferer(scheduler, scale_factor=scale_factor)
    conditioning = make_conditioning(gender, age, ventricular_vol, brain_vol,
                                     batch=latent_shape[0], device=noise.device)
    return inferer.sample(noise, autoencoder_model, diffusion_model, conditioning=conditioning,
                          generator=generator)
