"""Conditioned brain-LDM sampling (the model-zoo bundle's sampler).

Counterpart of generativemodels_tpu/recipes/brain_ldm_sampler.py: a 3D
latent diffusion model sampled with its scalar covariates (gender, age,
ventricular and brain volume) as a (B, 1, 4) cross-attention context, the
latent decoded by the 3D AutoencoderKL. The networks are built from the
`brain_3d_ldm` preset's numbers by the caller (the port has no YAML
parser yet); `brain_unet` and `brain_autoencoder` build them as the JAX
recipe `eval_brain_ldm.py` does.

As the JAX recipe, the UNet takes `in_channels` 3 and sees the covariates
only through cross-attention; the preset's `in_channels: 7` (the bundle
also concatenates them into the input) is not what the JAX sampler runs.
"""
from __future__ import annotations

import torch

from ..inferers import LatentDiffusionInferer
from ..networks.nets import AutoencoderKL, DiffusionModelUNet


def make_conditioning(
    gender: float, age: float, ventricular_vol: float, brain_vol: float, batch: int = 1,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Pack normalised covariates into a (B, 1, 4) float32 context."""
    vec = torch.tensor([gender, age, ventricular_vol, brain_vol], dtype=torch.float32,
                       device=device)
    return vec.reshape(1, 1, 4).expand(batch, 1, 4)


def brain_unet(
    num_channels=(256, 512, 768), num_head_channels=(0, 512, 768),
    dtype: torch.dtype | None = None, **overrides,
) -> DiffusionModelUNet:
    """The bundle's UNet (`config/presets/brain_3d_ldm.yaml:21-31`, with the
    JAX recipe's 3 input channels, `recipes/eval_brain_ldm.py:113-118`);
    `overrides` narrow it for tests."""
    kwargs = dict(
        spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=2,
        num_channels=num_channels, attention_levels=(False, True, True),
        num_head_channels=num_head_channels, with_conditioning=True, cross_attention_dim=4,
        upcast_attention=True, dtype=dtype,
    )
    kwargs.update(overrides)
    return DiffusionModelUNet(**kwargs)


def brain_autoencoder(
    num_channels=(64, 128, 128, 128), dtype: torch.dtype | None = None, **overrides
) -> AutoencoderKL:
    """The bundle's stage 1 (`brain_3d_ldm.yaml:7-18`): AEKL (64, 128, 128,
    128), two res blocks a level, no attention, 3 latent channels,
    checkpointed blocks (which only a backward reads)."""
    kwargs = dict(
        spatial_dims=3, in_channels=1, out_channels=1, latent_channels=3,
        num_channels=num_channels, num_res_blocks=2,
        attention_levels=(False,) * len(num_channels), with_encoder_nonlocal_attn=False,
        with_decoder_nonlocal_attn=False, use_checkpointing=True, dtype=dtype,
    )
    kwargs.update(overrides)
    return AutoencoderKL(**kwargs)


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
    device: torch.device | str | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample a batch of brain volumes conditioned on the covariates.

    The latent noise is `noise` if given, else drawn from `generator` (one
    seeded with 0 by default) on `device`; the same generator then drives
    any stochastic step. Returns the decoded (B, 1, *spatial) volume.
    """
    if noise is None:
        if generator is None:
            generator = torch.Generator(device or "cpu").manual_seed(0)
        noise = torch.randn(latent_shape, generator=generator, device=device)
    scheduler.set_timesteps(num_inference_steps, device=noise.device)
    inferer = LatentDiffusionInferer(scheduler, scale_factor=scale_factor)
    conditioning = make_conditioning(gender, age, ventricular_vol, brain_vol,
                                     batch=latent_shape[0], device=noise.device)
    return inferer.sample(noise, autoencoder_model, diffusion_model, conditioning=conditioning,
                          generator=generator)
