"""Noise-schedule registry and scheduler base class.

Counterpart of generativemodels_tpu/networks/schedulers/scheduler.py.

The coefficient tables are float32 tensors on the scheduler's device and
are gathered with a timestep *tensor* (`torch.take`), so a sampling loop
over a device timestep tensor never waits on the host.
"""
from __future__ import annotations

import math

import torch

from ...utils import ComponentStore, unsqueeze_right

NoiseSchedules = ComponentStore("NoiseSchedules", "Functions to generate noise schedules")


@NoiseSchedules.add_def("linear_beta", "Linear beta schedule")
def _linear_beta(num_train_timesteps: int, beta_start: float = 1e-4, beta_end: float = 2e-2):
    """Linear beta noise schedule: betas evenly spaced in [beta_start, beta_end]."""
    return torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)


@NoiseSchedules.add_def("scaled_linear_beta", "Scaled linear beta schedule")
def _scaled_linear_beta(num_train_timesteps: int, beta_start: float = 1e-4, beta_end: float = 2e-2):
    """Scaled-linear (stable-diffusion style) schedule: sqrt-space linear, squared."""
    return (
        torch.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=torch.float32)
        ** 2
    )


@NoiseSchedules.add_def("sigmoid_beta", "Sigmoid beta schedule")
def _sigmoid_beta(
    num_train_timesteps: int,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
    sig_range: float = 6,
):
    """Sigmoid-shaped beta schedule over [-sig_range, sig_range]."""
    x = torch.linspace(-sig_range, sig_range, num_train_timesteps, dtype=torch.float32)
    return 1.0 / (1.0 + torch.exp(-x)) * (beta_end - beta_start) + beta_start


@NoiseSchedules.add_def("cosine", "Cosine schedule")
def _cosine_beta(num_train_timesteps: int, s: float = 8e-3):
    """Cosine schedule (Nichol & Dhariwal, https://arxiv.org/abs/2102.09672).

    Returns the (betas, alphas, alphas_cumprod) triple.
    """
    x = torch.linspace(0, num_train_timesteps, num_train_timesteps + 1, dtype=torch.float32)
    alphas_cumprod = torch.cos(((x / num_train_timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    alphas = torch.clip(alphas_cumprod[1:] / alphas_cumprod[:-1], 0.0001, 0.9999)
    betas = 1.0 - alphas
    return betas, alphas, alphas_cumprod[:-1]


class Scheduler:
    """Base class holding precomputed schedule coefficient tables.

    A schedule function from :data:`NoiseSchedules` returns either a beta
    tensor or a (betas, alphas, alphas_cumprod) triple. The tables live on
    `device` and are gathered with integer timestep tensors.

    Args:
        num_train_timesteps: number of diffusion steps the model trains with.
        schedule: name of a registered member of NoiseSchedules.
        device: where the tables and `timesteps` live.
        schedule_args: forwarded keyword args for the schedule function.
    """

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        schedule: str = "linear_beta",
        device: torch.device | str | None = None,
        **schedule_args,
    ) -> None:
        schedule_args["num_train_timesteps"] = num_train_timesteps
        noise_sched = NoiseSchedules[schedule](**schedule_args)
        self.device = torch.device(device or "cpu")

        if isinstance(noise_sched, tuple):
            betas, alphas, alphas_cumprod = noise_sched
        else:
            betas = noise_sched
            alphas = 1.0 - betas
            alphas_cumprod = torch.cumprod(alphas, dim=0)
        self.betas = betas.to(self.device)
        self.alphas = alphas.to(self.device)
        self.alphas_cumprod = alphas_cumprod.to(self.device)

        self.num_train_timesteps = num_train_timesteps
        self.schedule = schedule

        # settable values
        self.num_inference_steps: int | None = None
        # sampling plan (descending timesteps), iterated by the inferer
        self.timesteps = torch.arange(num_train_timesteps - 1, -1, -1, device=self.device)

    def _move_to(self, device: torch.device | str | None) -> None:
        """Make `device` the scheduler's and move every table there; None
        leaves both as they are. `set_timesteps(..., device=)` calls it
        first, so the plan and the tables that each step gathers from with
        `torch.take` stay on one device."""
        if device is None:
            return
        self.device = torch.device(device)
        for name, value in list(vars(self).items()):
            if isinstance(value, torch.Tensor):
                setattr(self, name, value.to(self.device))

    # -- gather helpers (timestep tensors, no host sync) --------------------

    def _t(self, timesteps) -> torch.Tensor:
        return torch.as_tensor(timesteps, device=self.device)

    def _gather(self, table: torch.Tensor, timesteps) -> torch.Tensor:
        return torch.take(table, self._t(timesteps))

    def _alpha_cumprod_prev(self, timestep, final: float = 1.0) -> torch.Tensor:
        """alphas_cumprod[t-1], or `final` where t-1 < 0."""
        t = self._t(timestep)
        prev = torch.take(self.alphas_cumprod, (t - 1).clamp(min=0))
        return torch.where(t > 0, prev, torch.full_like(prev, final))

    # -- public API ---------------------------------------------------------

    def add_noise(
        self, original_samples: torch.Tensor, noise: torch.Tensor, timesteps
    ) -> torch.Tensor:
        """Forward-noise x0 to x_t: sqrt(abar_t) x0 + sqrt(1-abar_t) eps."""
        abar = self._gather(self.alphas_cumprod, timesteps).to(original_samples.dtype)
        sqrt_abar = unsqueeze_right(torch.sqrt(abar), original_samples.ndim)
        sqrt_one_minus = unsqueeze_right(torch.sqrt(1.0 - abar), original_samples.ndim)
        return sqrt_abar * original_samples + sqrt_one_minus * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        """v-prediction target: sqrt(abar_t) eps - sqrt(1-abar_t) x0."""
        abar = self._gather(self.alphas_cumprod, timesteps).to(sample.dtype)
        sqrt_abar = unsqueeze_right(torch.sqrt(abar), sample.ndim)
        sqrt_one_minus = unsqueeze_right(torch.sqrt(1.0 - abar), sample.ndim)
        return sqrt_abar * noise - sqrt_one_minus * sample


def draw_noise(
    like: torch.Tensor,
    noise: torch.Tensor | None,
    generator: torch.Generator | None,
) -> torch.Tensor | None:
    """The step noise: `noise` as given, else drawn from `generator`, else None."""
    if noise is not None or generator is None:
        return noise
    return torch.randn(
        like.shape, generator=generator, device=like.device, dtype=like.dtype
    )
