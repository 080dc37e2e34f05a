"""Stable-diffusion-upscaler style super-resolution helpers.

Counterpart of generativemodels_tpu/recipes/super_resolution.py (the
reference's 2d_stable_diffusion_v2_super_resolution tutorial): noise
conditioning augmentation. The low-resolution conditioning image is itself
noised with a second scheduler, upsampled, concatenated to the model's
input channels, and the noise level is fed through `class_labels`. The
upsampling is `jax.image.resize`'s nearest rule, half-pixel centres:
torch's `nearest-exact`, which differs from torch's `nearest` (a floor) at
a non-integer ratio.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ..inferers.latent import _resize_spatial
from ..networks.schedulers import DDPMScheduler
from .draws import Draws


def prepare_sr_batch(
    low_res: torch.Tensor,
    low_res_scheduler,
    generator: torch.Generator | None = None,
    max_noise_level: int = 350,
    noise_level: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise-augment the low-resolution conditioning of one training batch.

    Draws the noise level (B,) in [0, max_noise_level), then the noise, from
    `generator`, unless given. Returns (noised_low_res, noise_level); the
    level feeds the model's `class_labels`.
    """
    if generator is None and (noise_level is None or noise is None):
        generator = torch.Generator(low_res.device).manual_seed(0)
    if noise_level is None:
        noise_level = torch.randint(0, max_noise_level, (low_res.shape[0],),
                                    generator=generator, device=low_res.device)
    if noise is None:
        noise = torch.randn(low_res.shape, generator=generator, device=low_res.device,
                            dtype=low_res.dtype)
    return low_res_scheduler.add_noise(low_res, noise, noise_level), noise_level


def sample_super_resolution(
    model_fn,
    scheduler,
    low_res: torch.Tensor,
    upscale_factor: int,
    noise_level: int = 20,
    generator: torch.Generator | None = None,
    low_res_scheduler=None,
    noise: Iterable[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Upscale `low_res` by sampling the super-resolution diffusion model.

    Args:
        model_fn: `(x, timesteps, class_labels) -> prediction`, x the concat
            of the noisy high-resolution image and the upsampled noised
            conditioning.
        scheduler: DDPM or DDIM scheduler with timesteps set.
        low_res: (B, C, *spatial) conditioning image.
        upscale_factor: spatial upscale multiple.
        noise_level: conditioning-augmentation level used at sampling time.
        generator: the draws' generator (one seeded with 0 by default).
        low_res_scheduler: noises the conditioning (default `scheduler`).
        noise: the draws in their order, in place of `generator`'s: the
            initial high-resolution sample, the conditioning's noise, then
            a DDPM step's noise at each step.
    """
    draws = Draws(low_res.device, generator, noise)
    low_res_scheduler = low_res_scheduler or scheduler
    b, c = low_res.shape[:2]
    high_spatial = tuple(s * upscale_factor for s in low_res.shape[2:])
    image = draws.normal((b, c) + high_spatial)

    # noise-augment the conditioning once, then upsample to the target size
    levels = torch.full((b,), noise_level, dtype=torch.long, device=low_res.device)
    cond_noise = draws.normal(low_res.shape)
    noised_low_res = low_res_scheduler.add_noise(low_res, cond_noise, levels)
    upsampled = _resize_spatial(noised_low_res, high_spatial, "nearest")

    is_ddpm = isinstance(scheduler, DDPMScheduler)
    for t in scheduler.timesteps:
        model_in = torch.cat([image, upsampled], dim=1)
        pred = model_fn(model_in, t.expand(b), levels)
        if is_ddpm:
            image, _ = scheduler.step(pred, t, image, noise=draws.normal(pred.shape, pred.dtype))
        else:
            image, _ = scheduler.step(pred, t, image)
    return image


def compute_scale_factor(latents: torch.Tensor) -> torch.Tensor:
    """LDM latent scale factor = 1 / std(z) of the first training batch (the
    population std, as `jnp.std`)."""
    return 1.0 / torch.std(latents, correction=0)
