"""DPM-Solver++ multistep scheduler (Lu et al. 2022, arXiv:2211.01095).

Counterpart of generativemodels_tpu/networks/schedulers/dpmsolver.py. The
plan is computed as the JAX scheduler computes it: `set_timesteps` builds
the grid ("uniform_lambda" or "leading"), the sigma = 0 boundary, the SDE
coefficients and the second-order lookback weight in float64 numpy, then
keeps the four per-step tables as float32 tensors on the scheduler's
device. `step` is gathers and multiply-adds on the device; it never reads a
device value back to the host.

The JAX `DPMSolverState` pytree becomes a NamedTuple of a Python int
counter (the port's sampling loop runs on the host), the previous data
prediction, and a `torch.Generator` in place of the PRNG key (the SDE
variant's noise stream).
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ...utils import StrEnum
from .scheduler import Scheduler


class DPMSolverPredictionType(StrEnum):
    EPSILON = "epsilon"
    SAMPLE = "sample"
    V_PREDICTION = "v_prediction"


class DPMSolverAlgorithmType(StrEnum):
    DPMSOLVER_PP = "dpmsolver++"
    SDE_DPMSOLVER_PP = "sde-dpmsolver++"


class DPMSolverState(NamedTuple):
    """What one step hands the next."""

    counter: int  # index into the inference plan
    prev_x0: torch.Tensor  # D_{i-1}: previous data prediction (zeros at i=0)
    generator: torch.Generator  # noise stream of the SDE variant (unused by the ODE)


class DPMSolverMultistepScheduler(Scheduler):
    """DPM-Solver++ (2M): second-order multistep fast ODE sampler.

    With ``h = lambda_t - lambda_s`` in log-SNR time and the data
    prediction ``D``, a step is ``x_t = (sigma_t / sigma_s) x_s + alpha_t
    (1 - e^{-h}) D_bar``. Order 1 uses ``D_bar = D_i`` (deterministic DDIM);
    order 2 adds ``D_bar = (1 + c) D_i - c D_{i-1}``, ``c = h_i / (2
    h_{i-1})``. The SDE variant carries ``(sigma_t / sigma_s) e^{-h}`` of the
    sample, injects ``alpha_t (1 - e^{-2h}) D_bar`` and adds fresh noise
    ``sigma_t sqrt(1 - e^{-2h})``.

    Args:
        num_train_timesteps: diffusion steps used at train time.
        schedule: NoiseSchedules member name.
        solver_order: 1 (== DDIM) or 2 (the "2M" method).
        prediction_type: member of DPMSolverPredictionType.
        algorithm_type: "dpmsolver++" (the ODE) or "sde-dpmsolver++".
        clip_sample: clip the data prediction each step.
        set_alpha_to_one: the final boundary alpha-bar is 1.0 (zero final
            sigma; that step is forced to order 1).
        lower_order_final: force order 1 on the final step of plans
            shorter than 15 steps.
        timestep_spacing: "uniform_lambda" (uniform in log-SNR, snapped to
            trained timesteps, duplicates collapsed) or "leading" (the
            DDIMScheduler grid).
        steps_offset: added to the timesteps under "leading" spacing.
        clip_sample_min, clip_sample_max: the clipping range.
        device: where the tables and `timesteps` live.
    """

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        schedule: str = "linear_beta",
        solver_order: int = 2,
        prediction_type: str = DPMSolverPredictionType.EPSILON,
        algorithm_type: str = DPMSolverAlgorithmType.DPMSOLVER_PP,
        clip_sample: bool = False,
        set_alpha_to_one: bool = True,
        lower_order_final: bool = True,
        timestep_spacing: str = "uniform_lambda",
        steps_offset: int = 0,
        clip_sample_min: float = -1.0,
        clip_sample_max: float = 1.0,
        device: torch.device | str | None = None,
        **schedule_args,
    ) -> None:
        super().__init__(num_train_timesteps, schedule, device=device, **schedule_args)

        if prediction_type not in DPMSolverPredictionType.__members__.values():
            raise ValueError(
                "Argument `prediction_type` must be a member of DPMSolverPredictionType"
            )
        if solver_order not in (1, 2):
            raise ValueError(f"solver_order must be 1 or 2, got {solver_order}")
        if algorithm_type not in DPMSolverAlgorithmType.__members__.values():
            raise ValueError(
                "Argument `algorithm_type` must be a member of DPMSolverAlgorithmType"
            )
        if timestep_spacing not in ("uniform_lambda", "leading"):
            raise ValueError(
                f"timestep_spacing must be 'uniform_lambda' or 'leading', got {timestep_spacing}"
            )
        if clip_sample_min >= clip_sample_max:
            raise ValueError("clip_sample_min must be < clip_sample_max")

        self.prediction_type = prediction_type
        self.algorithm_type = algorithm_type
        self.solver_order = solver_order
        self.clip_sample = clip_sample
        self.clip_sample_values = (clip_sample_min, clip_sample_max)
        self.lower_order_final = lower_order_final
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset
        self.final_alpha_cumprod_value = (
            1.0 if set_alpha_to_one else float(self.alphas_cumprod[0])
        )
        self.init_noise_sigma = 1.0

        self.set_timesteps(num_train_timesteps)

    # -- plan ----------------------------------------------------------------

    def set_timesteps(
        self, num_inference_steps: int, device: torch.device | str | None = None
    ) -> None:
        """Build the inference plan and its per-step coefficient tables.

        `num_inference_steps` afterwards holds the realised plan length
        ("uniform_lambda" collapses duplicate timesteps). `device`, when
        given, becomes the scheduler's device: the plan and every table move
        there (the JAX signature's argument).
        """
        if num_inference_steps > self.num_train_timesteps:
            raise ValueError(
                f"`num_inference_steps`: {num_inference_steps} cannot be larger than "
                f"`num_train_timesteps`: {self.num_train_timesteps}"
            )
        self._move_to(device)
        abar = self.alphas_cumprod.cpu().numpy().astype(np.float64)
        if self.timestep_spacing == "leading":
            step_ratio = self.num_train_timesteps // num_inference_steps
            timesteps = (
                (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
            )
            timesteps = timesteps + self.steps_offset
        else:  # uniform_lambda
            lam_full = 0.5 * (np.log(abar) - np.log1p(-abar))  # ascending as t descends
            targets = np.linspace(lam_full[-1], lam_full[0], num_inference_steps)
            idx = np.abs(lam_full[None, :] - targets[:, None]).argmin(axis=1)
            timesteps_list: list[int] = []
            for t in idx:
                if not timesteps_list or int(t) < timesteps_list[-1]:
                    timesteps_list.append(int(t))
            timesteps = np.asarray(timesteps_list, dtype=np.int64)
        n = len(timesteps)
        self.num_inference_steps = n
        self.timesteps = torch.as_tensor(timesteps, dtype=torch.long, device=self.device)

        # f64 plan: abar at each visited timestep, plus the final boundary;
        # the source abar of step i is [i], its target [i+1]
        abar_path = np.concatenate([abar[timesteps], [self.final_alpha_cumprod_value]])
        alpha = np.sqrt(abar_path)
        sigma = np.sqrt(1.0 - abar_path)
        with np.errstate(divide="ignore"):  # the final sigma may be 0: lam = +inf
            lam = np.log(alpha) - np.log(sigma)

        alpha_s, alpha_t = alpha[:-1], alpha[1:]
        sigma_s, sigma_t = sigma[:-1], sigma[1:]
        h = lam[1:] - lam[:-1]  # log-SNR increments, > 0; may be +inf at the end

        # e^{-h} from the ratios: exactly 0 at sigma_t == 0, no inf arithmetic
        exp_neg_h = (sigma_t * alpha_s) / (sigma_s * alpha_t)
        if self.algorithm_type == DPMSolverAlgorithmType.SDE_DPMSOLVER_PP:
            c_x = (sigma_t / sigma_s) * exp_neg_h
            c_d = alpha_t * (1.0 - exp_neg_h**2)
            c_n = sigma_t * np.sqrt(np.maximum(1.0 - exp_neg_h**2, 0.0))
        else:
            c_x = sigma_t / sigma_s  # sample carry
            c_d = alpha_t * (1.0 - exp_neg_h)  # data carry
            c_n = np.zeros(n, dtype=np.float64)

        # lookback weight, zero where the step is forced to order 1: the first
        # step, a final step onto sigma = 0, and the final step of short plans
        c2 = np.zeros(n, dtype=np.float64)
        if self.solver_order == 2 and n >= 2:
            c2[1:] = h[1:] / (2.0 * h[:-1])
            if sigma_t[-1] == 0.0:
                c2[-1] = 0.0
            elif self.lower_order_final and n < 15:
                c2[-1] = 0.0

        def table(a):
            return torch.as_tensor(a.astype(np.float32), device=self.device)

        self._c_x, self._c_d, self._c_n, self._c2 = map(table, (c_x, c_d, c_n, c2))

    # -- explicit state --------------------------------------------------------

    def init_state(
        self,
        sample_shape: tuple[int, ...],
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> DPMSolverState:
        """The state before the first step; `generator` drives the SDE noise."""
        if generator is None:
            if self.algorithm_type == DPMSolverAlgorithmType.SDE_DPMSOLVER_PP:
                warnings.warn(
                    "DPMSolverScheduler.init_state: algorithm_type='sde-dpmsolver++' "
                    "with generator=None uses a generator seeded with 0 - every run "
                    "draws the SAME 'stochastic' noise. Pass "
                    "generator=torch.Generator(device).manual_seed(seed) for distinct "
                    "samples.",
                    stacklevel=2,
                )
            generator = torch.Generator(self.device).manual_seed(0)
        return DPMSolverState(
            counter=0,
            prev_x0=torch.zeros(sample_shape, dtype=dtype, device=self.device),
            generator=generator,
        )

    # -- core math -------------------------------------------------------------

    def _predict_x0(self, model_output, sample, timestep):
        """Data prediction D(x_t, t) per configured prediction type."""
        abar = self._gather(self.alphas_cumprod, timestep)
        sqrt_a = torch.sqrt(abar)
        sqrt_b = torch.sqrt(1.0 - abar)
        if self.prediction_type == DPMSolverPredictionType.EPSILON:
            x0 = (sample - sqrt_b * model_output) / sqrt_a
        elif self.prediction_type == DPMSolverPredictionType.SAMPLE:
            x0 = model_output
        else:  # v_prediction
            x0 = sqrt_a * sample - sqrt_b * model_output
        if self.clip_sample:
            x0 = torch.clamp(x0, *self.clip_sample_values)
        return x0

    def step(
        self, state: DPMSolverState, model_output: torch.Tensor, timestep, sample: torch.Tensor,
        noise: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, DPMSolverState]:
        """One DPM-Solver++ multistep update x_{t_i} -> x_{t_{i+1}}.

        `timestep` must be `self.timesteps[state.counter]`, as the inferer
        passes it. Returns (prev_sample, new_state); `state` itself is not
        changed (the SDE variant advances its generator, unless `noise`, the
        f32 step noise, is given: then it draws nothing).
        """
        i = state.counter
        x0 = self._predict_x0(model_output, sample, timestep).float()

        c2 = self._c2[i]
        d_bar = (1.0 + c2) * x0 - c2 * state.prev_x0.float()
        prev_sample = self._c_x[i] * sample.float() + self._c_d[i] * d_bar
        if self.algorithm_type == DPMSolverAlgorithmType.SDE_DPMSOLVER_PP:
            if noise is None:
                noise = torch.randn(
                    prev_sample.shape, generator=state.generator, device=prev_sample.device,
                    dtype=torch.float32,
                )
            prev_sample = prev_sample + self._c_n[i] * noise
        new_state = DPMSolverState(
            counter=i + 1, prev_x0=x0.to(state.prev_x0.dtype), generator=state.generator
        )
        return prev_sample.to(sample.dtype), new_state
