"""Diffusion inferer: training forward and reverse sampling.

Counterpart of generativemodels_tpu/inferers/inferer.py (`__call__` and
`sample`). The reverse loop is a Python loop over the scheduler's device
timestep tensor, in place of the JAX `lax.scan`; each timestep stays a
0-d device tensor, so the loop never waits on the host. `diffusion_model`
is any callable `(x, timesteps, context=None)` returning the prediction.
Stochastic steps draw from an explicit `torch.Generator`. A stateful
scheduler (one with `init_state`, as DPM-Solver++) threads its state through
`step(state, model_output, t, sample)`, as the JAX scan carries it.

Not ported yet: `get_likelihood` and SPADE `seg`.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..networks.schedulers import DDPMScheduler

ModelFn = Callable[..., torch.Tensor]


class DiffusionInferer:
    """Pairs a diffusion model callable with a scheduler (DDPM, DDIM or DPM-Solver++)."""

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

        `generator` draws the DDPM ancestral noise, the DDIM eta > 0 noise
        and the SDE DPM-Solver++ noise; it defaults to one seeded with 0 on
        the noise's device.
        """
        if mode not in ("crossattn", "concat"):
            raise NotImplementedError(f"{mode} condition is not supported")
        scheduler = scheduler or self.scheduler
        if generator is None:
            generator = torch.Generator(input_noise.device).manual_seed(0)
        # stateful schedulers (DPM-Solver++) carry an explicit state:
        # step(state, model_output, t, sample)
        is_stateful = hasattr(scheduler, "init_state")
        is_ddpm = isinstance(scheduler, DDPMScheduler)
        if is_stateful:
            state = scheduler.init_state(input_noise.shape, input_noise.dtype, generator=generator)

        image = input_noise
        for t in scheduler.timesteps:
            x, ctx = image, conditioning
            if mode == "concat":
                x, ctx = torch.cat([image, conditioning], dim=1), None
            model_output = diffusion_model(x, t.expand(image.shape[0]), context=ctx)
            if is_stateful:
                image, state = scheduler.step(state, model_output, t, image)
            elif is_ddpm:
                image, _ = scheduler.step(model_output, t, image, generator=generator)
            else:  # DDIM
                image, _ = scheduler.step(
                    model_output, t, image, eta=eta, generator=generator if eta > 0 else None
                )
        return image
