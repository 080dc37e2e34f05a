"""Diffusion inferer: training forward, reverse sampling, likelihood.

Counterpart of generativemodels_tpu/inferers/inferer.py. The reverse loop
and the likelihood loop are Python loops over the scheduler's device
timestep tensor, in place of the JAX `lax.scan`; each timestep stays a
0-d device tensor, so the loops never wait on the device. What the host
decides per step (which steps `save_intermediates` keeps, the decoder term
at t = 0) it reads from one host copy of the plan, taken before the loop.
`diffusion_model` is any callable `(x, timesteps, context=None)` returning
the prediction; given a SPADE segmentation `seg`, it is also called with
`seg=seg` (the SPADE UNet's argument), as in JAX. Stochastic steps draw
from an explicit `torch.Generator`. A stateful scheduler (one with
`init_state`: PNDM, DPM-Solver++) threads its state through `step(state,
model_output, t, sample)`, as the JAX scan carries it.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ..networks.schedulers import DDPMScheduler

ModelFn = Callable[..., torch.Tensor]


def _call_model(model: ModelFn, x, timesteps, context, seg):
    kwargs: dict[str, Any] = {}
    if seg is not None:
        kwargs["seg"] = seg
    return model(x, timesteps, context=context, **kwargs)


def _host_timesteps(scheduler) -> list[int]:
    """The plan as Python ints: one copy to the host, before a loop."""
    return scheduler.timesteps.tolist()


class DiffusionInferer:
    """Pairs a diffusion model callable with a scheduler (DDPM, DDIM, PNDM or DPM-Solver++)."""

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
        seg: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One supervised training forward: add_noise then predict."""
        if mode not in ("crossattn", "concat"):
            raise NotImplementedError(f"{mode} condition is not supported")
        noisy_image = self.scheduler.add_noise(inputs, noise, timesteps)
        if mode == "concat":
            noisy_image = torch.cat([noisy_image, condition], dim=1)
            condition = None
        return _call_model(diffusion_model, noisy_image, timesteps, condition, seg)

    @staticmethod
    def _model_input(image, conditioning, mode):
        if mode == "concat":
            return torch.cat([image, conditioning], dim=1), None
        return image, conditioning

    def sample(
        self,
        input_noise: torch.Tensor,
        diffusion_model: ModelFn,
        scheduler=None,
        save_intermediates: bool = False,
        intermediate_steps: int = 100,
        conditioning: torch.Tensor | None = None,
        mode: str = "crossattn",
        verbose: bool = False,
        seg: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        eta: float = 0.0,
        step_noise: torch.Tensor | None = None,
    ):
        """Full reverse-diffusion loop from `input_noise`.

        Returns the image, or with `save_intermediates` (image, the images
        after every step whose timestep is a multiple of
        `intermediate_steps`). `generator` draws the DDPM ancestral noise,
        the DDIM eta > 0 noise and the SDE DPM-Solver++ noise; it defaults
        to one seeded with 0 on the noise's device. `step_noise` (steps,
        *input_noise.shape), when given, is that noise, step by step, in
        place of the generator's draws: a graph that `torch.export` records
        holds no generator, so an exported sampler takes its noise as input.
        """
        if mode not in ("crossattn", "concat"):
            raise NotImplementedError(f"{mode} condition is not supported")
        scheduler = scheduler or self.scheduler
        if generator is None:
            generator = torch.Generator(input_noise.device).manual_seed(0)
        # stateful schedulers (PNDM, DPM-Solver++) carry an explicit state:
        # step(state, model_output, t, sample)
        is_stateful = hasattr(scheduler, "init_state")
        is_ddpm = isinstance(scheduler, DDPMScheduler)
        if is_stateful:
            state = scheduler.init_state(input_noise.shape, input_noise.dtype, generator=generator)
        host_timesteps = (
            _host_timesteps(scheduler) if save_intermediates or verbose else None
        )

        image, intermediates = input_noise, []
        for i, t in enumerate(scheduler.timesteps):
            if verbose:
                print(f"sampling step {i + 1}/{len(host_timesteps)} (t={host_timesteps[i]})")
            x, ctx = self._model_input(image, conditioning, mode)
            model_output = _call_model(diffusion_model, x, t.expand(image.shape[0]), ctx, seg)
            noise = step_noise[i] if step_noise is not None else None
            if is_stateful:
                step_kwargs = {"noise": noise} if noise is not None else {}
                image, state = scheduler.step(state, model_output, t, image, **step_kwargs)
            elif is_ddpm:
                image, _ = scheduler.step(model_output, t, image, generator=generator, noise=noise)
            else:  # DDIM
                image, _ = scheduler.step(
                    model_output, t, image, eta=eta, generator=generator if eta > 0 else None,
                    noise=noise,
                )
            if save_intermediates and host_timesteps[i] % intermediate_steps == 0:
                intermediates.append(image)
        return (image, intermediates) if save_intermediates else image

    def get_likelihood(
        self,
        inputs: torch.Tensor,
        diffusion_model: ModelFn,
        scheduler=None,
        save_intermediates: bool = False,
        conditioning: torch.Tensor | None = None,
        mode: str = "crossattn",
        original_input_range: tuple = (0, 255),
        scaled_input_range: tuple = (0, 1),
        verbose: bool = False,
        seg: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """Per-image ELBO: the sum over the plan of KL(q(x_{t-1} | x_t, x_0)
        || p(x_{t-1} | x_t)), with a discretised Gaussian decoder NLL at t = 0.

        The corruption noise is drawn once per call from `generator` (one
        seeded with 0 on the input's device by default), or given as
        `noise`, which makes the two frameworks comparable. Returns the
        (B,) totals, or with `save_intermediates` (totals, every step's KL
        map).
        """
        scheduler = scheduler or self.scheduler
        if not isinstance(scheduler, DDPMScheduler):
            raise NotImplementedError(
                "Likelihood computation is only compatible with DDPMScheduler"
            )
        if mode not in ("crossattn", "concat"):
            raise NotImplementedError(f"{mode} condition is not supported")
        if noise is None:
            if generator is None:
                generator = torch.Generator(inputs.device).manual_seed(0)
            noise = torch.randn(
                inputs.shape, generator=generator, device=inputs.device, dtype=inputs.dtype
            )
        learned = scheduler.variance_type in ("learned", "learned_range")

        total_kl = torch.zeros(inputs.shape[0], device=inputs.device)
        intermediates = []
        host_timesteps = _host_timesteps(scheduler)
        for i, t in enumerate(scheduler.timesteps):
            if verbose:
                print(f"likelihood step {i + 1}/{len(host_timesteps)}")
            tt = t.expand(inputs.shape[0])
            noisy_image = scheduler.add_noise(inputs, noise, tt)
            x, ctx = self._model_input(noisy_image, conditioning, mode)
            model_output = _call_model(diffusion_model, x, tt, ctx, seg)
            if model_output.shape[1] == inputs.shape[1] * 2 and learned:
                model_output, predicted_variance = torch.chunk(model_output, 2, dim=1)
            else:
                predicted_variance = None

            alpha_prod_t = torch.take(scheduler.alphas_cumprod, t)
            alpha_prod_t_prev = scheduler._alpha_cumprod_prev(t)
            beta_prod_t = 1.0 - alpha_prod_t
            beta_prod_t_prev = 1.0 - alpha_prod_t_prev

            if scheduler.prediction_type == "epsilon":
                pred_x0 = (noisy_image - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(
                    alpha_prod_t
                )
            elif scheduler.prediction_type == "sample":
                pred_x0 = model_output
            else:  # v_prediction
                pred_x0 = (
                    torch.sqrt(alpha_prod_t) * noisy_image - torch.sqrt(beta_prod_t) * model_output
                )
            if scheduler.clip_sample:
                pred_x0 = torch.clamp(pred_x0, -1, 1)

            beta_t = torch.take(scheduler.betas, t)
            alpha_t = torch.take(scheduler.alphas, t)
            pred_x0_coeff = torch.sqrt(alpha_prod_t_prev) * beta_t / beta_prod_t
            current_coeff = torch.sqrt(alpha_t) * beta_prod_t_prev / beta_prod_t
            predicted_mean = pred_x0_coeff * pred_x0 + current_coeff * noisy_image

            posterior_mean = scheduler._get_mean(t, inputs, noisy_image)
            if learned:
                # the true posterior variance of q(x_{t-1} | x_t, x_0) (DDPM
                # eq. 7): the scheduler's learned-variance accessor needs the
                # model output and does not define it
                posterior_variance = torch.clamp(
                    beta_prod_t_prev / beta_prod_t * beta_t, min=1e-20
                )
            else:
                posterior_variance = scheduler._get_variance(t)
            log_posterior_variance = torch.log(posterior_variance)
            if predicted_variance is not None:
                # the model's variance channel through the scheduler's
                # interpolation, as the JAX package defines it
                model_variance = scheduler._get_variance(t, predicted_variance)
                log_predicted_variance = torch.log(torch.clamp(model_variance, min=1e-20))
            else:
                log_predicted_variance = log_posterior_variance

            if host_timesteps[i] == 0:  # discretised decoder NLL
                kl = -self._get_decoder_log_likelihood(
                    inputs=inputs,
                    means=predicted_mean,
                    log_scales=0.5 * log_predicted_variance,
                    original_input_range=original_input_range,
                    scaled_input_range=scaled_input_range,
                )
            else:  # KL between the true posterior and the model's gaussian
                kl = 0.5 * (
                    -1.0
                    + log_predicted_variance
                    - log_posterior_variance
                    + torch.exp(log_posterior_variance - log_predicted_variance)
                    + ((posterior_mean - predicted_mean) ** 2)
                    * torch.exp(-log_predicted_variance)
                )
            total_kl = total_kl + kl.reshape(kl.shape[0], -1).mean(dim=1)
            if save_intermediates:
                intermediates.append(kl)
        return (total_kl, intermediates) if save_intermediates else total_kl

    @staticmethod
    def _approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
        """Fast tanh approximation of the standard normal CDF."""
        return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))

    def _get_decoder_log_likelihood(
        self,
        inputs: torch.Tensor,
        means: torch.Tensor,
        log_scales: torch.Tensor,
        original_input_range: tuple = (0, 255),
        scaled_input_range: tuple = (0, 1),
    ) -> torch.Tensor:
        """Log-likelihood of a Gaussian discretised to the input's bin width."""
        if inputs.shape != means.shape:
            raise ValueError("inputs and means must have the same shape")
        bin_width = (scaled_input_range[1] - scaled_input_range[0]) / (
            original_input_range[1] - original_input_range[0]
        )
        centered_x = inputs - means
        inv_stdv = torch.exp(-log_scales)
        cdf_plus = self._approx_standard_normal_cdf(inv_stdv * (centered_x + bin_width / 2))
        cdf_min = self._approx_standard_normal_cdf(inv_stdv * (centered_x - bin_width / 2))
        log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
        log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
        log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
        return torch.where(
            inputs < -0.999,
            log_cdf_plus,
            torch.where(inputs > 0.999, log_one_minus_cdf_min, log_cdf_delta),
        )
