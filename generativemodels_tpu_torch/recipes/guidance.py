"""Classifier-free guidance sampling.

Counterpart of generativemodels_tpu/recipes/guidance.py (the reference
tutorial's recipe): train with the condition replaced by an unconditional
value at some probability, sample with the batch doubled and the guided
prediction `uncond + g * (cond - uncond)`. The JAX scan becomes a Python
loop over the scheduler's device timesteps; explicit `torch.Generator`s
take the place of the keys. The stateful solvers (DPM-Solver++, PNDM)
carry their state through the loop, as the scan carries it.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from ..networks.schedulers import DDPMScheduler


def drop_condition(
    condition: torch.Tensor,
    uncond_value,
    prob: float,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Each batch element's condition replaced by `uncond_value` with
    probability `prob` (the reference trains its guidance with class -1 at
    15%). The draws come from `generator` (torch's default one if None)."""
    draw = torch.rand(condition.shape[0], generator=generator, device=condition.device)
    mask = (draw < prob).reshape((-1,) + (1,) * (condition.ndim - 1))
    return torch.where(mask, torch.as_tensor(uncond_value, dtype=condition.dtype,
                                             device=condition.device), condition)


def guided_prediction(
    model_fn: Callable, image: torch.Tensor, t: torch.Tensor, conditioning: torch.Tensor,
    unconditioning: torch.Tensor, guidance_scale: float,
) -> torch.Tensor:
    """One guided model evaluation: the batch doubled (conditional half
    first), then uncond + guidance_scale * (cond - uncond)."""
    doubled = torch.cat([image, image], dim=0)
    context = torch.cat([conditioning, unconditioning], dim=0)
    pred = model_fn(doubled, t.expand(doubled.shape[0]), context)
    cond_pred, uncond_pred = pred.chunk(2, dim=0)
    return uncond_pred + guidance_scale * (cond_pred - uncond_pred)


def sample_with_guidance(
    model_fn: Callable,
    scheduler,
    input_noise: torch.Tensor,
    conditioning: torch.Tensor,
    unconditioning: torch.Tensor,
    guidance_scale: float = 7.0,
    generator: torch.Generator | None = None,
    eta: float = 0.0,
    noise: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Reverse diffusion with classifier-free guidance (batch doubling).

    Args:
        model_fn: `(x, timesteps, context) -> prediction`.
        scheduler: DDPM, DDIM, DPM-Solver++ or PNDM, with timesteps set.
        input_noise: (B, C, *spatial) starting noise.
        conditioning, unconditioning: the context of the conditional and
            the unconditional half, (B, S, D) (or class labels (B,)).
        guidance_scale: g in `uncond + g * (cond - uncond)`.
        generator: draws the DDPM and DDIM eta > 0 step noise and the SDE
            solver's; one seeded with 0 on the noise's device by default.
        eta: DDIM's eta.
        noise: one tensor per step, taken by the DDPM (or DDIM eta > 0)
            step in place of a draw from `generator`, so that a caller can
            give both frameworks the same noise.
    """
    if generator is None:
        generator = torch.Generator(input_noise.device).manual_seed(0)
    is_ddpm = isinstance(scheduler, DDPMScheduler)
    is_stateful = hasattr(scheduler, "init_state")
    image = input_noise
    if is_stateful:
        state = scheduler.init_state(input_noise.shape, input_noise.dtype, generator=generator)
    for i, t in enumerate(scheduler.timesteps):
        guided = guided_prediction(model_fn, image, t, conditioning, unconditioning,
                                   guidance_scale)
        step_noise = None if noise is None else noise[i]
        if is_stateful:
            image, state = scheduler.step(state, guided, t, image)
        elif is_ddpm:
            image, _ = scheduler.step(guided, t, image, generator=generator, noise=step_noise)
        else:
            image, _ = scheduler.step(
                guided, t, image, eta=eta, generator=generator if eta > 0 else None,
                noise=step_noise if eta > 0 else None,
            )
    return image
