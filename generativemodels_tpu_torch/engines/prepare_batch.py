"""Batch preparation for diffusion training.

Counterpart of generativemodels_tpu/engines/prepare_batch.py:
`DiffusionPrepareBatch` draws the noise and uniform timesteps, from the
`torch.Generator` passed to it in place of a JAX key (the noise first), and
returns (images, target, kwargs); `VPredictionPrepareBatch` targets the
scheduler's velocity. `get_noise` and `get_timesteps` are the seams a
caller overrides to inject its own draws.
"""
from __future__ import annotations

import torch


class DiffusionPrepareBatch:
    """Prepares (images, target=noise, {"noise", "timesteps"[, "conditioning"]})."""

    def __init__(
        self,
        num_train_timesteps: int,
        condition_name: str | None = None,
        image_key: str = "image",
    ) -> None:
        self.condition_name = condition_name
        self.num_train_timesteps = num_train_timesteps
        self.image_key = image_key

    def get_target(self, images, noise, timesteps):
        return noise

    def get_noise(self, images: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        return torch.randn(images.shape, generator=generator, device=images.device,
                           dtype=images.dtype)

    def get_timesteps(
        self, images: torch.Tensor, generator: torch.Generator | None
    ) -> torch.Tensor:
        return torch.randint(0, self.num_train_timesteps, (images.shape[0],),
                             generator=generator, device=images.device)

    def __call__(self, batchdata, generator: torch.Generator | None = None):
        images = batchdata[self.image_key] if isinstance(batchdata, dict) else batchdata
        noise = self.get_noise(images, generator)
        timesteps = self.get_timesteps(images, generator)
        target = self.get_target(images, noise, timesteps)
        kwargs = {"noise": noise, "timesteps": timesteps}
        if self.condition_name is not None and isinstance(batchdata, dict):
            kwargs["conditioning"] = batchdata[self.condition_name]
        return images, target, kwargs


class VPredictionPrepareBatch(DiffusionPrepareBatch):
    """Same as DiffusionPrepareBatch but targets the velocity."""

    def __init__(
        self,
        scheduler,
        num_train_timesteps: int,
        condition_name: str | None = None,
        image_key: str = "image",
    ) -> None:
        super().__init__(num_train_timesteps, condition_name, image_key)
        self.scheduler = scheduler

    def get_target(self, images, noise, timesteps):
        return self.scheduler.get_velocity(images, noise, timesteps)
