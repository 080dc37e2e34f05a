"""DDPM scheduler (Ho et al. 2020).

Counterpart of generativemodels_tpu/networks/schedulers/ddpm.py (variance
types fixed_small/fixed_large/learned/learned_range, prediction types
epsilon/sample/v_prediction). Branches on the timestep use `torch.where`,
so `step` takes a device timestep tensor without a host sync. The
ancestral noise is passed in (`noise=`) or drawn from a `torch.Generator`.
"""
from __future__ import annotations

import torch

from ...utils import StrEnum
from .scheduler import Scheduler, draw_noise


class DDPMVarianceType(StrEnum):
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED = "learned"
    LEARNED_RANGE = "learned_range"


class DDPMPredictionType(StrEnum):
    EPSILON = "epsilon"
    SAMPLE = "sample"
    V_PREDICTION = "v_prediction"


class DDPMScheduler(Scheduler):
    """Ancestral DDPM sampler.

    Args:
        num_train_timesteps: diffusion steps used at train time.
        schedule: NoiseSchedules member name.
        variance_type: member of DDPMVarianceType.
        clip_sample: clip predicted x0 into [clip_sample_min, clip_sample_max].
        prediction_type: member of DDPMPredictionType.
        device: where the coefficient tables and `timesteps` live.
        schedule_args: forwarded to the schedule function.
    """

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        schedule: str = "linear_beta",
        variance_type: str = DDPMVarianceType.FIXED_SMALL,
        clip_sample: bool = True,
        prediction_type: str = DDPMPredictionType.EPSILON,
        clip_sample_min: float = -1.0,
        clip_sample_max: float = 1.0,
        device: torch.device | str | None = None,
        **schedule_args,
    ) -> None:
        super().__init__(num_train_timesteps, schedule, device=device, **schedule_args)

        if variance_type not in DDPMVarianceType.__members__.values():
            raise ValueError("Argument `variance_type` must be a member of `DDPMVarianceType`")
        if prediction_type not in DDPMPredictionType.__members__.values():
            raise ValueError("Argument `prediction_type` must be a member of `DDPMPredictionType`")
        if clip_sample_min >= clip_sample_max:
            raise ValueError("clip_sample_min must be < clip_sample_max")

        self.clip_sample = clip_sample
        self.variance_type = variance_type
        self.prediction_type = prediction_type
        self.clip_sample_values = (clip_sample_min, clip_sample_max)

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
        self.timesteps = torch.arange(
            (num_inference_steps - 1) * step_ratio, -1, -step_ratio, device=self.device
        )

    def _get_mean(self, timestep, x_0: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        """Posterior mean of q(x_{t-1} | x_t, x_0) (DDPM eq. 7)."""
        t = self._t(timestep)
        alpha_t = torch.take(self.alphas, t)
        alpha_prod_t = torch.take(self.alphas_cumprod, t)
        alpha_prod_t_prev = self._alpha_cumprod_prev(t)
        beta_t = torch.take(self.betas, t)

        x0_coef = torch.sqrt(alpha_prod_t_prev) * beta_t / (1.0 - alpha_prod_t)
        xt_coef = torch.sqrt(alpha_t) * (1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t)
        return x0_coef * x_0 + xt_coef * x_t

    def _get_variance(self, timestep, predicted_variance: torch.Tensor | None = None):
        """Posterior variance at t, per configured variance_type."""
        t = self._t(timestep)
        alpha_prod_t = torch.take(self.alphas_cumprod, t)
        alpha_prod_t_prev = self._alpha_cumprod_prev(t)
        beta_t = torch.take(self.betas, t)

        variance = (1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t) * beta_t
        if self.variance_type == DDPMVarianceType.FIXED_SMALL:
            variance = torch.clamp(variance, min=1e-20)
        elif self.variance_type == DDPMVarianceType.FIXED_LARGE:
            variance = beta_t
        elif self.variance_type == DDPMVarianceType.LEARNED:
            return predicted_variance
        elif self.variance_type == DDPMVarianceType.LEARNED_RANGE:
            min_log = variance
            max_log = beta_t
            frac = (predicted_variance + 1.0) / 2.0
            variance = frac * max_log + (1.0 - frac) * min_log
        return variance

    def step(
        self,
        model_output: torch.Tensor,
        timestep,
        sample: torch.Tensor,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One reverse-diffusion step x_t -> x_{t-1}.

        Args:
            model_output: raw network output (channel-doubled when the
                variance is learned).
            timestep: scalar int timestep (python int or 0-d tensor).
            sample: x_t, shape (B, C, *spatial).
            generator: draws the ancestral noise when `noise` is None.
            noise: the ancestral noise itself. With neither, the step is
                deterministic (no noise term).

        Returns:
            (pred_prev_sample, pred_original_sample)
        """
        if (
            model_output.shape[1] == sample.shape[1] * 2
            and self.variance_type in (DDPMVarianceType.LEARNED, DDPMVarianceType.LEARNED_RANGE)
        ):
            model_output, predicted_variance = torch.chunk(model_output, 2, dim=1)
        else:
            predicted_variance = None

        t = self._t(timestep)
        alpha_prod_t = torch.take(self.alphas_cumprod, t)
        alpha_prod_t_prev = self._alpha_cumprod_prev(t)
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev

        if self.prediction_type == DDPMPredictionType.EPSILON:
            pred_original_sample = (sample - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(
                alpha_prod_t
            )
        elif self.prediction_type == DDPMPredictionType.SAMPLE:
            pred_original_sample = model_output
        else:  # v_prediction
            pred_original_sample = (
                torch.sqrt(alpha_prod_t) * sample - torch.sqrt(beta_prod_t) * model_output
            )

        if self.clip_sample:
            pred_original_sample = torch.clamp(pred_original_sample, *self.clip_sample_values)

        beta_t = torch.take(self.betas, t)
        alpha_t = torch.take(self.alphas, t)
        pred_original_sample_coeff = torch.sqrt(alpha_prod_t_prev) * beta_t / beta_prod_t
        current_sample_coeff = torch.sqrt(alpha_t) * beta_prod_t_prev / beta_prod_t

        pred_prev_sample = (
            pred_original_sample_coeff * pred_original_sample + current_sample_coeff * sample
        )

        noise = draw_noise(model_output, noise, generator)
        if noise is not None:
            std = torch.sqrt(self._get_variance(t, predicted_variance=predicted_variance))
            # no noise at t == 0 (a tensor gate, not a host branch)
            pred_prev_sample = pred_prev_sample + torch.where(t > 0, std, 0.0) * noise

        return pred_prev_sample, pred_original_sample
