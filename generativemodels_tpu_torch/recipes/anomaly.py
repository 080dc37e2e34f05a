"""Diffusion-based anomaly detection (DDIM encode -> decode -> error map).

Counterpart of generativemodels_tpu/recipes/anomaly.py (the reference's
DDIMScheduler.reversed_step and the anomaly tutorials): an image is encoded
deterministically towards noise for L steps, decoded back, and the
reconstruction error read as an anomaly map; healthy structure survives
the round trip, anomalies do not. The JAX `lax.scan`s are Python loops over
the scheduler's device timesteps.
"""
from __future__ import annotations

import torch


def ddim_encode(model_fn, scheduler, image: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Deterministically encode an image to x_t by DDIM reversed steps."""
    x = image
    for t in scheduler.timesteps.flip(0)[:num_steps]:  # ascending
        pred = model_fn(x, t.expand(x.shape[0]))
        x, _ = scheduler.reversed_step(pred, t, x)
    return x


def ddim_decode(model_fn, scheduler, latent: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Deterministic DDIM decoding from x_t back to image space.

    Mirrors `ddim_encode`: the first decode timestep is one stride above the
    last encode timestep, so decoding retraces the encoding (the step at t
    consumes x_t and emits x_{t-delta}). Raises ValueError where that first
    timestep lies past the training schedule (JAX's gather reads NaN there).
    """
    delta = scheduler.num_train_timesteps // scheduler.num_inference_steps
    timesteps = scheduler.timesteps.flip(0)[:num_steps].flip(0) + delta
    if num_steps and int(timesteps[0]) >= scheduler.num_train_timesteps:
        raise ValueError(
            f"{num_steps} steps of stride {delta} start the decode at timestep "
            f"{int(timesteps[0])}, past the schedule's {scheduler.num_train_timesteps}"
        )
    x = latent
    for t in timesteps:
        pred = model_fn(x, t.expand(x.shape[0]))
        x, _ = scheduler.step(pred, t, x, eta=0.0)
    return x


def anomaly_map(
    model_fn, scheduler, image: torch.Tensor, encode_steps: int = 250
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (reconstruction, |image - reconstruction| anomaly map).

    `scheduler` is a DDIMScheduler with `set_timesteps` already called;
    `encode_steps` counts inference steps (not train timesteps).
    """
    latent = ddim_encode(model_fn, scheduler, image, encode_steps)
    recon = ddim_decode(model_fn, scheduler, latent, encode_steps)
    return recon, (image - recon).abs()
