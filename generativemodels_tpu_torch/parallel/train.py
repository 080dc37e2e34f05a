"""Diffusion training steps.

Counterpart of generativemodels_tpu/parallel/train.py on one device. The
JAX step is a jitted function of immutable params and optax state; here
the state holds the model, whose parameters are the params, and a torch
optimizer (`torch.optim.Adam` for `optax.adam`: both take the same update,
eps outside the square root), and a step updates both in place. Noise and
timesteps are drawn from an explicit `torch.Generator` in place of a JAX
key; `DiffusionTrainStep.update` takes them as given, which is how the tests
feed it the draws of the JAX step.

Under a mesh (`parallel/mesh.py`) the step has the JAX step's global
meaning: each rank passes its own rows of the global batch (and, with
`spatial_shard_axis=2`, its own slab of axis 2, under `spatial_cut`), the
loss and the gradients are those of the global batch, and every rank ends
with the same parameters. The gradients are summed over "space" and
averaged over "data" in one all-reduce after the backward (after the last
microbatch when accumulating), and the loss likewise. Every rank draws the
global batch's noise and timesteps from the same generator, in the
single-device order, and keeps its own rows and slab: an N-rank step then
equals the one-rank step on the full batch, up to the order of the
reduction. The model's parameters start equal on every rank
(`mesh.shard_params`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh, spatial_sharding
from .spatial import CUT_DIM, cut_mean, spatial_cut


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
        mesh: a `parallel.Mesh`; the images are then this rank's rows of
            the global batch over its "data" axis.
        spatial_shard_axis: with a mesh, the images' axis cut over "space"
            (2, the outermost spatial axis), run under `spatial_cut`.
    """

    def __init__(
        self,
        scheduler,
        num_train_timesteps: int | None = None,
        prediction_target: str = "epsilon",
        accumulate_steps: int = 1,
        ema_decay: float | None = None,
        mesh: Mesh | None = None,
        spatial_shard_axis: int | None = None,
    ) -> None:
        check_mesh(mesh, spatial_shard_axis)
        self.scheduler = scheduler
        self.num_train_timesteps = num_train_timesteps or scheduler.num_train_timesteps
        self.prediction_target = prediction_target
        self.accumulate_steps = accumulate_steps
        self.ema_decay = ema_decay
        self.mesh = mesh
        self.spatial_shard_axis = spatial_shard_axis

    def loss_fn(
        self, model: nn.Module, images: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor
    ) -> torch.Tensor:
        """Mean squared error of the model's prediction at (noise, timesteps);
        under a spatial cut, this slab's share of its rows' mean (`cut_mean`)."""
        noisy = self.scheduler.add_noise(images, noise, timesteps)
        pred = model(noisy, timesteps)
        if self.prediction_target == "epsilon":
            target = noise
        elif self.prediction_target == "v_prediction":
            target = self.scheduler.get_velocity(images, noise, timesteps)
        else:
            target = images
        return cut_mean((pred - target) ** 2)

    def _size(self, axis: str) -> int:
        return self.mesh.axis_size(axis) if self.mesh is not None else 1

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

    def _reduce(self, model: nn.Module, loss: torch.Tensor) -> torch.Tensor:
        """The gradients and the loss of the global batch, on every rank."""
        if self.mesh is not None:
            loss = loss.clone()
            reduce_over_mesh_([p.grad for p in model.parameters() if p.grad is not None]
                              + [loss.reshape(1)], self.mesh)
        return loss

    def update(
        self, state: TrainState, images: torch.Tensor, noise: torch.Tensor, timesteps: torch.Tensor
    ) -> tuple[TrainState, torch.Tensor]:
        """The step with its noise and timesteps given (under a mesh, this
        rank's rows and slab of the global draws): loss, gradients, one
        optimizer update, the EMA; returns the advanced state and the loss."""
        state.optimizer.zero_grad(set_to_none=True)
        with self._placement():
            loss = self._backward(state.model, images, noise, timesteps)
            loss = self._reduce(state.model, loss)
        state.optimizer.step()
        ema_params = _ema_update(state, self.ema_decay)
        return TrainState(state.model, state.optimizer, state.step + 1, ema_params), loss

    def _placement(self):
        return placement(self.mesh, self.spatial_shard_axis)

    def _local(self, x: torch.Tensor, with_space: bool) -> torch.Tensor:
        """This rank's piece of a global draw."""
        if self.mesh is None:
            return x
        if with_space and self.spatial_shard_axis is not None:
            return spatial_sharding(self.mesh, x.ndim,
                                    spatial_axis_index=self.spatial_shard_axis).shard(x)
        return x.chunk(self._size("data"))[self.mesh.index("data")]

    def __call__(
        self, state: TrainState, images: torch.Tensor, generator: torch.Generator
    ) -> tuple[TrainState, torch.Tensor]:
        shape = list(images.shape)
        shape[0] *= self._size("data")
        if self.spatial_shard_axis is not None:
            shape[self.spatial_shard_axis] *= self._size("space")
        noise = torch.randn(shape, generator=generator, device=images.device, dtype=images.dtype)
        timesteps = torch.randint(
            0, self.num_train_timesteps, (shape[0],), generator=generator, device=images.device,
        )
        return self.update(state, images, self._local(noise, True), self._local(timesteps, False))


def check_mesh(mesh: Mesh | None, spatial_shard_axis: int | None) -> Mesh | None:
    """`mesh` if a step can take it: a `parallel.Mesh` whose "space" axis,
    if it has more than one rank, the step cuts (`spatial_shard_axis=2`:
    the ranks of one space group would otherwise each count the same rows);
    `spatial_shard_axis` needs a "space" axis, and the cut takes axis 2."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh).__name__}")
    if spatial_shard_axis is not None:
        if mesh is None:
            raise ValueError("spatial_shard_axis needs a mesh with a 'space' axis")
        if "space" not in mesh.shape:
            raise ValueError(f"mesh has no axis 'space': {mesh.axis_names}")
        if spatial_shard_axis != CUT_DIM:
            raise ValueError(f"the spatial cut takes axis {CUT_DIM} (the outermost), got "
                             f"{spatial_shard_axis}")
    elif mesh is not None and mesh.axis_size("space") > 1:
        raise ValueError(f"a mesh with a 'space' axis ({mesh.shape}) needs spatial_shard_axis=2")
    return mesh


def placement(mesh: Mesh | None, spatial_shard_axis: int | None) -> contextlib.ExitStack:
    """`with mesh:` (and `spatial_cut` when the step cuts a spatial axis)."""
    stack = contextlib.ExitStack()
    if mesh is not None:
        stack.enter_context(mesh)
        if spatial_shard_axis is not None:
            stack.enter_context(spatial_cut(mesh, dim=spatial_shard_axis))
    return stack


@torch.no_grad()
def reduce_over_mesh_(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Sum `tensors` in place over every rank of the mesh, then divide by its
    "data" size: from each rank's share, the gradients (or losses) of the
    global batch's mean. One all-reduce a dtype, over a flat copy."""
    if not dist.is_initialized() or not tensors:
        return
    scale = 1.0 / mesh.axis_size("data")
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat)
        if scale != 1.0:
            flat.mul_(scale)
        for t, chunk in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(chunk.view_as(t))


def make_diffusion_train_step(
    scheduler,
    mesh: Mesh | None = None,
    num_train_timesteps: int | None = None,
    prediction_target: str = "epsilon",
    spatial_shard_axis: int | None = None,
    accumulate_steps: int = 1,
    ema_decay: float | None = None,
) -> DiffusionTrainStep:
    """Build a DDPM training step: `step(state, images, generator) -> (state, loss)`.

    See `DiffusionTrainStep` for the arguments.
    """
    return DiffusionTrainStep(
        scheduler, num_train_timesteps, prediction_target, accumulate_steps, ema_decay,
        mesh=mesh, spatial_shard_axis=spatial_shard_axis,
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
    ema_update_(state.model, state.ema_params, state.step, ema_decay)
    return state.ema_params


@torch.no_grad()
def ema_update_(
    model: nn.Module, ema_params: dict[str, torch.Tensor], step: int, ema_decay: float
) -> None:
    """`ema_params` (by parameter name) moved towards `model`'s parameters in
    place, with decay `min(ema_decay, (1+step)/(10+step))` in float32."""
    t = torch.tensor(step, dtype=torch.float32)
    d = torch.minimum(torch.tensor(ema_decay, dtype=torch.float32), (1.0 + t) / (10.0 + t))
    for name, p in model.named_parameters():
        e = ema_params[name]
        e.mul_(d).add_(p.to(e.dtype) * (1.0 - d))


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
