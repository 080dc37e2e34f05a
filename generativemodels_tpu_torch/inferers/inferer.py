"""Diffusion inferer: training forward and reverse sampling.

Counterpart of generativemodels_tpu/inferers/inferer.py (`__call__` and
`sample`). The reverse loop is a Python loop over the scheduler's device
timestep tensor, in place of the JAX `lax.scan`; each timestep stays a
0-d device tensor, so the loop never waits on the host. `diffusion_model`
is any callable `(x, timesteps, context=None)` returning the prediction.
Stochastic steps draw from an explicit `torch.Generator`.

Not ported yet: `get_likelihood`, SPADE `seg`, and stateful schedulers
(PNDM, DPM-Solver++).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..networks.schedulers import DDPMScheduler

ModelFn = Callable[..., torch.Tensor]


class DiffusionInferer:
    """Pairs a diffusion model callable with a scheduler (DDPM or DDIM)."""

    def __init__(self, scheduler) -> None:
        self.scheduler = scheduler

    def __call__(
        self,
        inputs: torch.Tensor,
        diffusion_model: ModelFn,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
        condition: torch.Tensor | None = None,
        mode: str = "crossattn",
    ) -> torch.Tensor:
        """One supervised training forward: add_noise then predict."""
        if mode not in ("crossattn", "concat"):
            raise NotImplementedError(f"{mode} condition is not supported")
        noisy_image = self.scheduler.add_noise(inputs, noise, timesteps)
        if mode == "concat":
            noisy_image = torch.cat([noisy_image, condition], dim=1)
            condition = None
        return diffusion_model(noisy_image, timesteps, context=condition)

    def sample(
        self,
        input_noise: torch.Tensor,
        diffusion_model: ModelFn,
        scheduler=None,
        conditioning: torch.Tensor | None = None,
        mode: str = "crossattn",
        generator: torch.Generator | None = None,
        eta: float = 0.0,
    ) -> torch.Tensor:
        """Full reverse-diffusion loop from `input_noise`.

        `generator` draws the DDPM ancestral noise and the DDIM eta > 0
        noise; it defaults to one seeded with 0 on the noise's device.
        """
        if mode not in ("crossattn", "concat"):
            raise NotImplementedError(f"{mode} condition is not supported")
        scheduler = scheduler or self.scheduler
        if generator is None:
            generator = torch.Generator(input_noise.device).manual_seed(0)
        is_ddpm = isinstance(scheduler, DDPMScheduler)

        image = input_noise
        for t in scheduler.timesteps:
            x, ctx = image, conditioning
            if mode == "concat":
                x, ctx = torch.cat([image, conditioning], dim=1), None
            model_output = diffusion_model(x, t.expand(image.shape[0]), context=ctx)
            if is_ddpm:
                image, _ = scheduler.step(model_output, t, image, generator=generator)
            else:  # DDIM
                image, _ = scheduler.step(
                    model_output, t, image, eta=eta, generator=generator if eta > 0 else None
                )
        return image
