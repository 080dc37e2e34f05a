"""DDIM scheduler (Song et al. 2021).

Counterpart of generativemodels_tpu/networks/schedulers/ddim.py: `step`
with eta-parameterised stochasticity and `reversed_step` for DDIM encoding.
"""
from __future__ import annotations

import torch

from ...utils import StrEnum
from .scheduler import Scheduler, draw_noise


class DDIMPredictionType(StrEnum):
    EPSILON = "epsilon"
    SAMPLE = "sample"
    V_PREDICTION = "v_prediction"


class DDIMScheduler(Scheduler):
    """Deterministic/stochastic DDIM sampler.

    Args:
        num_train_timesteps: diffusion steps used at train time.
        schedule: NoiseSchedules member name.
        clip_sample: clip predicted x0 for stability.
        set_alpha_to_one: use 1.0 as the previous alpha-bar on the final step
            (and 0.0 as the "next" alpha-bar on the first reversed step).
        steps_offset: offset added to inference timesteps (stable-diffusion
            compatibility, combined with set_alpha_to_one=False).
        prediction_type: member of DDIMPredictionType.
        device: where the coefficient tables and `timesteps` live.
    """

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        schedule: str = "linear_beta",
        clip_sample: bool = True,
        set_alpha_to_one: bool = True,
        steps_offset: int = 0,
        prediction_type: str = DDIMPredictionType.EPSILON,
        clip_sample_min: float = -1.0,
        clip_sample_max: float = 1.0,
        device: torch.device | str | None = None,
        **schedule_args,
    ) -> None:
        super().__init__(num_train_timesteps, schedule, device=device, **schedule_args)

        if prediction_type not in DDIMPredictionType.__members__.values():
            raise ValueError("Argument `prediction_type` must be a member of DDIMPredictionType")
        if clip_sample_min >= clip_sample_max:
            raise ValueError("clip_sample_min must be < clip_sample_max")

        self.prediction_type = prediction_type
        self.final_alpha_cumprod = (
            torch.ones((), device=self.device) if set_alpha_to_one else self.alphas_cumprod[0]
        )
        self.first_alpha_cumprod = (
            torch.zeros((), device=self.device) if set_alpha_to_one else self.alphas_cumprod[-1]
        )
        self.init_noise_sigma = 1.0
        self.clip_sample = clip_sample
        self.clip_sample_values = (clip_sample_min, clip_sample_max)
        self.steps_offset = steps_offset

        self.set_timesteps(num_train_timesteps)

    def set_timesteps(
        self, num_inference_steps: int, device: torch.device | str | None = None
    ) -> None:
        """Choose the (strided) subset of train timesteps used at inference.

        `device`, when given, becomes the scheduler's device: the plan and
        every coefficient table move there (the JAX signature's argument).
        """
        if num_inference_steps > self.num_train_timesteps:
            raise ValueError(
                f"`num_inference_steps`: {num_inference_steps} cannot be larger than "
                f"`num_train_timesteps`: {self.num_train_timesteps}"
            )
        self._move_to(device)
        self.num_inference_steps = num_inference_steps
        step_ratio = self.num_train_timesteps // num_inference_steps
        self.timesteps = (
            torch.arange((num_inference_steps - 1) * step_ratio, -1, -step_ratio, device=self.device)
            + self.steps_offset
        )

    def _gather_prev(self, prev_timestep) -> torch.Tensor:
        """alphas_cumprod[prev_t], or final_alpha_cumprod where prev_t < 0."""
        pt = self._t(prev_timestep)
        val = torch.take(self.alphas_cumprod, pt.clamp(min=0))
        return torch.where(pt >= 0, val, self.final_alpha_cumprod)

    def _get_variance(self, timestep, prev_timestep) -> torch.Tensor:
        alpha_prod_t = self._gather(self.alphas_cumprod, timestep)
        alpha_prod_t_prev = self._gather_prev(prev_timestep)
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev
        return (beta_prod_t_prev / beta_prod_t) * (1.0 - alpha_prod_t / alpha_prod_t_prev)

    def _predict(self, model_output, sample, alpha_prod_t):
        """Return (pred_x0, pred_epsilon) per configured prediction type."""
        beta_prod_t = 1.0 - alpha_prod_t
        if self.prediction_type == DDIMPredictionType.EPSILON:
            pred_x0 = (sample - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(alpha_prod_t)
            pred_eps = model_output
        elif self.prediction_type == DDIMPredictionType.SAMPLE:
            pred_x0 = model_output
            pred_eps = (sample - torch.sqrt(alpha_prod_t) * pred_x0) / torch.sqrt(beta_prod_t)
        else:  # v_prediction
            pred_x0 = torch.sqrt(alpha_prod_t) * sample - torch.sqrt(beta_prod_t) * model_output
            pred_eps = torch.sqrt(alpha_prod_t) * model_output + torch.sqrt(beta_prod_t) * sample
        if self.clip_sample:
            pred_x0 = torch.clamp(pred_x0, *self.clip_sample_values)
        return pred_x0, pred_eps

    def step(
        self,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        eta: float = 0.0,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One DDIM step x_t -> x_{t-dt} (formulas 12/16 of the DDIM paper).

        With eta > 0 the noise term uses `noise`, or draws it from
        `generator`; one of the two is required.
        """
        t = self._t(timestep)
        prev_timestep = t - self.num_train_timesteps // self.num_inference_steps

        alpha_prod_t = torch.take(self.alphas_cumprod, t)
        alpha_prod_t_prev = self._gather_prev(prev_timestep)

        pred_original_sample, pred_epsilon = self._predict(model_output, sample, alpha_prod_t)

        variance = self._get_variance(t, prev_timestep)
        std_dev_t = eta * torch.sqrt(variance)

        pred_sample_direction = torch.sqrt(1.0 - alpha_prod_t_prev - std_dev_t**2) * pred_epsilon
        pred_prev_sample = (
            torch.sqrt(alpha_prod_t_prev) * pred_original_sample + pred_sample_direction
        )

        if eta > 0:
            noise = draw_noise(model_output, noise, generator)
            if noise is None:
                raise ValueError("eta > 0 requires `generator` or `noise` for the DDIM noise term")
            pred_prev_sample = pred_prev_sample + eta * torch.sqrt(variance) * noise

        return pred_prev_sample, pred_original_sample

    def reversed_step(
        self, model_output: torch.Tensor, timestep, sample: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One DDIM *encoding* step x_t -> x_{t+dt} (image towards noise)."""
        t = self._t(timestep)
        next_timestep = t + self.num_train_timesteps // self.num_inference_steps

        alpha_prod_t = torch.take(self.alphas_cumprod, t)
        n = self.alphas_cumprod.shape[0]
        alpha_next_raw = torch.take(self.alphas_cumprod, next_timestep.clamp(0, n - 1))
        alpha_prod_t_next = torch.where(next_timestep < n, alpha_next_raw, self.first_alpha_cumprod)

        pred_original_sample, pred_epsilon = self._predict(model_output, sample, alpha_prod_t)

        pred_sample_direction = torch.sqrt(1.0 - alpha_prod_t_next) * pred_epsilon
        pred_next_sample = (
            torch.sqrt(alpha_prod_t_next) * pred_original_sample + pred_sample_direction
        )
        return pred_next_sample, pred_original_sample
