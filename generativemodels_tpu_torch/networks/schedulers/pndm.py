"""PNDM scheduler (Liu et al. 2022, arXiv:2202.09778).

Counterpart of generativemodels_tpu/networks/schedulers/pndm.py: a
Runge-Kutta warm-up (`_step_prk`) followed by the fourth-order linear
multistep (`_step_plms`), or PLMS alone under `skip_prk_steps`, with
formula (9) of the paper in `_get_prev_sample`.

The JAX `PNDMState` carries its step counter and its history length as
device int32 and picks each branch with `lax` conditionals, so that the
sampling loop compiles into one scan. The port's sampling loop runs on the
host, where the step count is known: `counter` is a Python int, the eps
history a tuple of at most four tensors (newest last), and every branch is
a Python `if`. Each step's timestep comes from a host copy of the plan at
`counter` (the inferer passes the same one as a device tensor), so a step
never reads a device value back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...utils import StrEnum
from .scheduler import Scheduler


class PNDMPredictionType(StrEnum):
    EPSILON = "epsilon"
    V_PREDICTION = "v_prediction"


class PNDMState(NamedTuple):
    """What one step hands the next."""

    counter: int  # step() calls so far
    cur_model_output: torch.Tensor  # Runge-Kutta accumulator
    cur_sample: torch.Tensor  # the sample kept across RK stages and the PLMS warm-up
    ets: tuple[torch.Tensor, ...]  # the last (up to) four model outputs, newest last


class PNDMScheduler(Scheduler):
    """Pseudo-numerical methods for diffusion models (F-PNDM, order 4).

    Args:
        num_train_timesteps: diffusion steps used at train time.
        schedule: NoiseSchedules member name.
        skip_prk_steps: skip the Runge-Kutta warm-up (PLMS only).
        set_alpha_to_one: use 1.0 as the previous alpha-bar past the final step.
        prediction_type: member of PNDMPredictionType.
        steps_offset: offset added to the inference timesteps.
        device: where the coefficient tables and `timesteps` live.
        schedule_args: forwarded to the schedule function.
    """

    pndm_order = 4

    def __init__(
        self,
        num_train_timesteps: int = 1000,
        schedule: str = "linear_beta",
        skip_prk_steps: bool = False,
        set_alpha_to_one: bool = False,
        prediction_type: str = PNDMPredictionType.EPSILON,
        steps_offset: int = 0,
        device: torch.device | str | None = None,
        **schedule_args,
    ) -> None:
        super().__init__(num_train_timesteps, schedule, device=device, **schedule_args)

        if prediction_type not in PNDMPredictionType.__members__.values():
            raise ValueError("Argument `prediction_type` must be a member of PNDMPredictionType")
        self.prediction_type = prediction_type
        self.final_alpha_cumprod = (
            torch.ones((), device=self.device) if set_alpha_to_one else self.alphas_cumprod[0]
        )
        self.init_noise_sigma = 1.0
        self.skip_prk_steps = skip_prk_steps
        self.steps_offset = steps_offset

        self.set_timesteps(num_train_timesteps)

    def set_timesteps(
        self, num_inference_steps: int, device: torch.device | str | None = None
    ) -> None:
        """The plan: the RK warm-up's timesteps (unless skipped), then PLMS's.

        As in the reference, `num_inference_steps` becomes the plan's length,
        the warm-up's steps included, and the step stride of both methods
        is `num_train_timesteps // num_inference_steps` of that length.
        `device`, when given, becomes the scheduler's device: the plan and
        every table move there (the JAX signature's argument).
        """
        if num_inference_steps > self.num_train_timesteps:
            raise ValueError(
                f"`num_inference_steps`: {num_inference_steps} cannot be larger than "
                f"`num_train_timesteps`: {self.num_train_timesteps}"
            )
        self._move_to(device)
        step_ratio = self.num_train_timesteps // num_inference_steps
        base = (np.arange(0, num_inference_steps) * step_ratio).round().astype(np.int64)
        base += self.steps_offset

        if self.skip_prk_steps:
            self.prk_timesteps = np.array([], dtype=np.int64)
            self.plms_timesteps = base[::-1].copy()
        else:
            # each of the warm-up's RK steps evaluates the model at t, t - d/2,
            # t - d/2 and t - d
            half = step_ratio // 2
            prk = np.repeat(base[-self.pndm_order :], 2) + np.tile(
                np.array([0, half], dtype=np.int64), self.pndm_order
            )
            self.prk_timesteps = (np.repeat(prk[:-1], 2)[1:-1])[::-1].copy()
            self.plms_timesteps = base[:-3][::-1].copy()

        self._plan = np.concatenate([self.prk_timesteps, self.plms_timesteps])
        self.timesteps = torch.from_numpy(self._plan).to(self.device)
        self.num_inference_steps = len(self._plan)

    def init_state(
        self, sample_shape: tuple[int, ...], dtype: torch.dtype = torch.float32, generator=None
    ) -> PNDMState:
        """The state before the first step. `generator` is accepted for the
        inferer's stateful-scheduler interface: PNDM draws no noise."""
        zeros = torch.zeros(sample_shape, dtype=dtype, device=self.device)
        return PNDMState(counter=0, cur_model_output=zeros, cur_sample=zeros, ets=())

    def _get_prev_sample(
        self, sample: torch.Tensor, timestep: int, prev_timestep: int, model_output: torch.Tensor
    ) -> torch.Tensor:
        """PNDM paper formula (9): x_t to x_{t - delta} given eps."""
        alpha_prod_t = self.alphas_cumprod[timestep]
        alpha_prod_t_prev = (
            self.alphas_cumprod[prev_timestep] if prev_timestep >= 0 else self.final_alpha_cumprod
        )
        beta_prod_t = 1.0 - alpha_prod_t
        beta_prod_t_prev = 1.0 - alpha_prod_t_prev

        if self.prediction_type == PNDMPredictionType.V_PREDICTION:
            model_output = (
                torch.sqrt(alpha_prod_t) * model_output + torch.sqrt(beta_prod_t) * sample
            )

        sample_coeff = torch.sqrt(alpha_prod_t_prev / alpha_prod_t)
        model_output_denom_coeff = alpha_prod_t * torch.sqrt(beta_prod_t_prev) + torch.sqrt(
            alpha_prod_t * beta_prod_t * alpha_prod_t_prev
        )
        return (
            sample_coeff * sample
            - (alpha_prod_t_prev - alpha_prod_t) * model_output / model_output_denom_coeff
        )

    def _step_plms(
        self, state: PNDMState, model_output: torch.Tensor, t: int, sample: torch.Tensor
    ) -> tuple[torch.Tensor, PNDMState]:
        delta = self.num_train_timesteps // self.num_inference_steps
        counter, ets = state.counter, state.ets
        second = counter == 1  # the PLMS warm-up redoes its first step from x_{t0}
        if not second:
            ets = (*ets, model_output)[-4:]

        if len(ets) <= 1:
            combined = (model_output + ets[-1]) / 2.0 if second else model_output
        elif len(ets) == 2:
            combined = (3.0 * ets[-1] - ets[-2]) / 2.0
        elif len(ets) == 3:
            combined = (23.0 * ets[-1] - 16.0 * ets[-2] + 5.0 * ets[-3]) / 12.0
        else:
            combined = (55.0 * ets[-1] - 59.0 * ets[-2] + 37.0 * ets[-3] - 9.0 * ets[-4]) / 24.0

        if second:
            prev_sample = self._get_prev_sample(state.cur_sample, t + delta, t, combined)
        else:
            prev_sample = self._get_prev_sample(sample, t, t - delta, combined)
        cur_sample = sample if counter == 0 else state.cur_sample
        return prev_sample, state._replace(counter=counter + 1, cur_sample=cur_sample, ets=ets)

    def _step_prk(
        self, state: PNDMState, model_output: torch.Tensor, t: int, sample: torch.Tensor
    ) -> tuple[torch.Tensor, PNDMState]:
        delta = self.num_train_timesteps // self.num_inference_steps
        counter, stage = state.counter, state.counter % 4
        prev_t = t - (delta // 2 if counter % 2 == 0 else 0)
        t_eff = int(self.prk_timesteps[(counter // 4) * 4])

        # RK accumulation: weights 1/6, 1/3, 1/3, then 1/6 with the sum
        acc = state.cur_model_output
        if stage == 3:
            model_output, new_acc = acc + model_output / 6.0, torch.zeros_like(acc)
        else:
            new_acc = acc + model_output / (6.0 if stage == 0 else 3.0)
        if stage == 0:
            state = state._replace(ets=(*state.ets, model_output)[-4:], cur_sample=sample)

        prev_sample = self._get_prev_sample(state.cur_sample, t_eff, prev_t, model_output)
        return prev_sample, state._replace(counter=counter + 1, cur_model_output=new_acc)

    def step(
        self, state: PNDMState, model_output: torch.Tensor, timestep, sample: torch.Tensor
    ) -> tuple[torch.Tensor, PNDMState]:
        """One PNDM step: the RK warm-up for the plan's first steps, then PLMS.

        The step's timestep is the plan's entry at `state.counter`;
        `timestep` (that entry as the inferer passes it) is not read.
        Returns (prev_sample, new_state); `state` itself does not change.
        """
        t = int(self._plan[state.counter])
        if state.counter < len(self.prk_timesteps):
            return self._step_prk(state, model_output, t, sample)
        return self._step_plms(state, model_output, t, sample)
