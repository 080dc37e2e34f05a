"""Diffusion training steps.

Counterpart of generativemodels_tpu/parallel/train.py on one device. The
JAX step is a jitted function of immutable params and optax state; here
the state holds the model, whose parameters are the params, and a torch
optimizer (`torch.optim.Adam` for `optax.adam`: both take the same update,
eps outside the square root), and a step updates both in place. Noise and
timesteps are drawn from an explicit `torch.Generator` in place of a JAX
key; `DiffusionTrainStep.update` takes them as given, which is how the tests
feed it the draws of the JAX step.

Not ported yet: `mesh` and `spatial_shard_axis` (the multi-device slice)
raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn


class TrainState(NamedTuple):
    model: nn.Module  # its parameters are the JAX state's `params`
    optimizer: torch.optim.Optimizer  # holds what the JAX state's `opt_state` holds
    step: int
    # exponential moving average of the parameters by name (None unless the
    # step was built with ema_decay); load it into a copy of the model to
    # sample from the EMA weights
    ema_params: dict[str, torch.Tensor] | None = None


class DiffusionTrainStep:
    """One DDPM training step: `step(state, images, generator) -> (state, loss)`.

    Args:
        scheduler: provides add_noise / get_velocity (tables on the images'
            device).
        num_train_timesteps: timestep draw range (default the scheduler's).
        prediction_target: "epsilon" | "v_prediction" | "sample".
        accumulate_steps: gradient accumulation. The batch is split into this
            many equal microbatches, one backward each (activation memory =
            one microbatch); gradients are averaged and applied in one
            optimizer update, numerically the full-batch step.
        ema_decay: if set, maintain `state.ema_params` (init with
            `init_train_state(..., ema=True)`). The decay warms up as
            `min(ema_decay, (1+step)/(10+step))`, step taken before the
            increment.
    """

    def __init__(
        self,
        scheduler,
        num_train_timesteps: int | None = None,
        prediction_target: str = "epsilon",
        accumulate_steps: int = 1,
        ema_decay: float | None = None,
    ) -> None:
        self.scheduler = scheduler
        self.num_train_timesteps = num_train_timesteps or scheduler.num_train_timesteps
        self.prediction_target = prediction_target
        self.accumulate_steps = accumulate_steps
        self.ema_decay = ema_decay

    def loss_fn(
        self, model: nn.Module, images: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor
    ) -> torch.Tensor:
        """Mean squared error of the model's prediction at (noise, timesteps)."""
        noisy = self.scheduler.add_noise(images, noise, timesteps)
        pred = model(noisy, timesteps)
        if self.prediction_target == "epsilon":
            target = noise
        elif self.prediction_target == "v_prediction":
            target = self.scheduler.get_velocity(images, noise, timesteps)
        else:
            target = images
        return torch.mean((pred - target) ** 2)

    def _backward(self, model, images, noise, timesteps) -> torch.Tensor:
        """Leaves the (averaged) gradients in `.grad`; returns the loss."""
        acc = self.accumulate_steps
        if acc == 1:
            loss = self.loss_fn(model, images, noise, timesteps)
            loss.backward()
            return loss.detach()
        if images.shape[0] % acc:
            raise ValueError(
                f"batch {images.shape[0]} not divisible by accumulate_steps={acc}"
            )
        total = torch.zeros((), dtype=torch.float32, device=images.device)
        for micro in zip(images.chunk(acc), noise.chunk(acc), timesteps.chunk(acc)):
            loss = self.loss_fn(model, *micro)
            loss.backward()  # .grad sums the microbatches' gradients
            total += loss.detach()
        inv = 1.0 / acc
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
        return total * inv

    def update(
        self, state: TrainState, images: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor
    ) -> tuple[TrainState, torch.Tensor]:
        """The step with its noise and timesteps given: loss, gradients, one
        optimizer update, the EMA; returns the advanced state and the loss."""
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._backward(state.model, images, noise, timesteps)
        state.optimizer.step()
        ema_params = _ema_update(state, self.ema_decay)
        return TrainState(state.model, state.optimizer, state.step + 1, ema_params), loss

    def __call__(
        self, state: TrainState, images: torch.Tensor, generator: torch.Generator
    ) -> tuple[TrainState, torch.Tensor]:
        noise = torch.randn(
            images.shape, generator=generator, device=images.device, dtype=images.dtype
        )
        timesteps = torch.randint(
            0, self.num_train_timesteps, (images.shape[0],), generator=generator,
            device=images.device,
        )
        return self.update(state, images, noise, timesteps)


def make_diffusion_train_step(
    scheduler,
    mesh=None,
    num_train_timesteps: int | None = None,
    prediction_target: str = "epsilon",
    spatial_shard_axis: int | None = None,
    accumulate_steps: int = 1,
    ema_decay: float | None = None,
) -> DiffusionTrainStep:
    """Build a DDPM training step: `step(state, images, generator) -> (state, loss)`.

    See `DiffusionTrainStep` for the arguments. `mesh` and
    `spatial_shard_axis` are not ported yet.
    """
    if mesh is not None or spatial_shard_axis is not None:
        raise NotImplementedError("mesh-sharded training is not ported yet")
    return DiffusionTrainStep(
        scheduler, num_train_timesteps, prediction_target, accumulate_steps, ema_decay
    )


def _ema_update(state: TrainState, ema_decay: float | None) -> dict[str, torch.Tensor] | None:
    """One EMA step with decay warmup, in place (no-op when ema_decay is None).

    Warmup `min(decay, (1+step)/(10+step))` in float32 from the step before
    the increment, as the JAX `_ema_update` computes it.
    """
    if ema_decay is None:
        return state.ema_params
    if state.ema_params is None:
        raise ValueError(
            "ema_decay is set but state.ema_params is None — "
            "initialise with init_train_state(model, optimizer, ema=True)"
        )
    step = torch.tensor(state.step, dtype=torch.float32)
    d = torch.minimum(torch.tensor(ema_decay, dtype=torch.float32), (1.0 + step) / (10.0 + step))
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            e = state.ema_params[name]
            e.mul_(d).add_(p.to(e.dtype) * (1.0 - d))
    return state.ema_params


def make_multi_step_train(
    scheduler,
    steps_per_call: int,
    num_train_timesteps: int | None = None,
    prediction_target: str = "epsilon",
    ema_decay: float | None = None,
):
    """Build `fn(state, stacked_images, generator) -> (state, losses[K])`
    running `steps_per_call` steps over a stacked batch (K, B, C, *spatial).

    The JAX function scans the steps inside one jitted program, one key
    each; here they run in a loop, each drawing from `generator` in turn.
    """
    step = DiffusionTrainStep(
        scheduler, num_train_timesteps, prediction_target, ema_decay=ema_decay
    )

    def multi(state: TrainState, stacked_images: torch.Tensor, generator: torch.Generator):
        if stacked_images.shape[0] != steps_per_call:
            raise ValueError(
                f"expected {steps_per_call} stacked batches, got {stacked_images.shape[0]}"
            )
        losses = []
        for images in stacked_images:
            state, loss = step(state, images, generator)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi


def init_train_state(
    model: nn.Module, optimizer: torch.optim.Optimizer, ema: bool = False
) -> TrainState:
    """The initial TrainState; `ema=True` seeds ema_params with copies of
    the parameters. `optimizer` is built over `model.parameters()`."""
    ema_params = (
        {name: p.detach().clone() for name, p in model.named_parameters()} if ema else None
    )
    return TrainState(model, optimizer, 0, ema_params)
