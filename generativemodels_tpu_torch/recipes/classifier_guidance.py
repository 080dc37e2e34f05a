"""Classifier-guided sampling and anomaly detection (Wolleb et al.).

Counterpart of generativemodels_tpu/recipes/classifier_guidance.py: during
the reverse loop the model's epsilon is shifted by the gradient of a
noise-aware classifier's log-probability of the target class (for example
a `DiffusionModelEncoder` trained on noised inputs), steering generation
towards it (towards "healthy", so that |x - x_guided| shows pathology).
The gradient with respect to x is taken under `torch.enable_grad` inside
the loop, so the sampler runs under `torch.no_grad` but not under
`torch.inference_mode`.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F

from ..networks.schedulers import DDPMScheduler
from .draws import Draws


def classifier_grad(classifier_fn, x: torch.Tensor, timesteps: torch.Tensor,
                    target_class: torch.Tensor) -> torch.Tensor:
    """d log p(y = target | x, t) / dx for a logits-producing classifier."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        logp = F.log_softmax(classifier_fn(x, timesteps), dim=-1)
        picked = torch.take_along_dim(logp, target_class[:, None], dim=1).sum()
        (grad,) = torch.autograd.grad(picked, x)
    return grad


def sample_with_classifier_guidance(
    model_fn,
    classifier_fn,
    scheduler,
    input_noise: torch.Tensor,
    target_class: torch.Tensor,
    guidance_scale: float = 1.0,
    generator: torch.Generator | None = None,
    eta: float = 0.0,
    noise: Iterable[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Reverse diffusion with classifier-gradient epsilon shifting.

    Args:
        model_fn: `(x, timesteps) -> epsilon` diffusion model.
        classifier_fn: `(x, timesteps) -> logits (B, num_classes)`.
        scheduler: DDPM or DDIM scheduler with timesteps set (epsilon
            prediction).
        input_noise: (B, C, *spatial) starting noise.
        target_class: (B,) int class to steer towards.
        guidance_scale: gradient scale s.
        generator: draws the DDPM (or DDIM eta > 0) step noise.
        eta: DDIM's eta.
        noise: those step noises in order, in place of `generator`'s.
    """
    draws = Draws(input_noise.device, generator, noise)
    is_ddpm = isinstance(scheduler, DDPMScheduler)
    image = input_noise
    for t in scheduler.timesteps:
        tt = t.expand(image.shape[0])
        eps = model_fn(image, tt)
        grad = classifier_grad(classifier_fn, image, tt, target_class)
        # eps_hat = eps - s * sqrt(1 - abar_t) * grad log p(y | x_t)
        abar = torch.take(scheduler.alphas_cumprod, t)
        eps = eps - guidance_scale * torch.sqrt(1.0 - abar) * grad
        if is_ddpm:
            image, _ = scheduler.step(eps, t, image, noise=draws.normal(eps.shape, eps.dtype))
        else:
            step_noise = draws.normal(eps.shape, eps.dtype) if eta > 0 else None
            image, _ = scheduler.step(eps, t, image, eta=eta, noise=step_noise)
    return image
