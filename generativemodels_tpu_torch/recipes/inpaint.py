"""RePaint-style inpainting.

Counterpart of generativemodels_tpu/recipes/inpaint.py (the reference's
2d_ddpm_inpainting tutorial): per timestep, U resampling iterations mix the
known region (the original, forward-noised to t) with the generated region
(one reverse step), then re-noise the mix back to t. The JAX nested
`lax.scan`s are Python loops.
"""
from __future__ import annotations

from typing import Iterable

import torch

from .draws import Draws


def inpaint(
    model_fn,
    scheduler,
    image: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None = None,
    num_resample_steps: int = 4,
    noise: Iterable[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Inpaint the masked region of `image` (mask == 1: region to generate).

    Args:
        model_fn: `(x, timesteps) -> epsilon prediction`.
        scheduler: DDPMScheduler with timesteps set.
        image: original image (B, C, *spatial).
        mask: 1 where content must be generated, 0 where known.
        generator: the draws' generator (one seeded with 0 by default).
        num_resample_steps: RePaint inner resampling iterations.
        noise: the draws, in place of `generator`'s, in their order: the
            initial sample, then at each timestep and resampling iteration
            the known region's noise, the reverse step's noise and the
            re-noising noise, each of the image's shape.
    """
    draws = Draws(image.device, generator, noise)
    x = draws.normal(image.shape, image.dtype)
    for t in scheduler.timesteps:
        tt = t.expand(image.shape[0])
        beta_t = torch.take(scheduler.betas, t)
        for _ in range(num_resample_steps):
            # known region: the original forward-noised to t
            x_known = scheduler.add_noise(image, draws.normal(image.shape, image.dtype), tt)
            # unknown region: one reverse step from the current sample
            pred = model_fn(x, tt)
            x_unknown, _ = scheduler.step(pred, t, x,
                                          noise=draws.normal(pred.shape, pred.dtype))
            x_next = x_known * (1.0 - mask) + x_unknown * mask
            # re-noise back to t for the next resampling iteration
            renoise = draws.normal(image.shape, image.dtype)
            x = torch.sqrt(1.0 - beta_t) * x_next + torch.sqrt(beta_t) * renoise
        # the last iteration's combined sample, not re-noised
        x = x_next
    return x
