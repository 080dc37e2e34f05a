"""Adversarial (generator / discriminator) training engine.

Counterpart of generativemodels_tpu/engines/trainer.py. The JAX step is one
jitted program of immutable params and optax states; here the state holds
both models, whose parameters and buffers are the params and model states,
and their torch optimizers, and a step updates them in place. The order
inside one step is the JAX step's:

1. G's forward; D's forward on the fakes with D's parameters and buffers as
   they were (BatchNorm statistics that this call moves are restored, as
   the JAX step drops the new D state); the reconstruction loss plus
   `adv_weight` times the adversarial generator loss; G's backward and
   update. D's parameters take no gradient here.
2. D's forward on the reals, then on the detached fakes, the buffers moving
   through both calls; the discriminator loss; D's backward and update.
3. With `ema_decay`, the EMA of G's parameters, decay
   `min(ema_decay, (1+t)/(10+t))` at the step t before the increment.

G's sampling noise (an AutoencoderKL's latent draw) comes from the
`torch.Generator` passed to the step, so that a test can replay the draw.

With a mesh (`parallel/mesh.py`) each rank passes its rows of the global
batch, and with `spatial_shard_axis=2` its slab of axis 2 over "space";
the step runs inside `with mesh:` (so a synced BatchNorm and the EMA
codebook take global statistics) and, when it cuts, under `spatial_cut`
(the convolutions take their halos, the norms and the losses' means their
statistics over the slabs: parallel/spatial.py). G's and D's gradients are
summed over every rank and divided by the "data" size before their
updates, and the losses it returns are those of the global batch: the
single-device step on the full batch, as the JAX step is whatever the
inputs' sharding. An AutoencoderKL G draws its latent noise for the global
batch on every rank and keeps its rows and slab (`parallel.mesh.draw_local`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..parallel.mesh import Mesh
from ..parallel.train import check_mesh, ema_update_, placement, reduce_over_mesh_
from ..utils import AdversarialIterationEvents, AdversarialKeys


class AdversarialTrainState(NamedTuple):
    g_model: nn.Module  # its parameters and buffers: the JAX state's g_params, g_model_state
    g_optimizer: torch.optim.Optimizer
    d_model: nn.Module
    d_optimizer: torch.optim.Optimizer
    step: int
    # EMA of G's parameters by name (None unless the step was built with
    # ema_decay): what VQ-GAN and AEKL users deploy
    g_ema_params: dict[str, torch.Tensor] | None = None


def detach(tree):
    """Tensors of a tensor, tuple or list, detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return type(tree)(detach(t) for t in tree)


@contextlib.contextmanager
def frozen(model: nn.Module):
    """`model` as it is: its parameters take no gradient and its buffers
    (BatchNorm statistics) are restored on exit."""
    params = [p for p in model.parameters() if p.requires_grad]
    buffers = {name: b.clone() for name, b in model.named_buffers()}
    for p in params:
        p.requires_grad_(False)
    try:
        yield model
    finally:
        for p in params:
            p.requires_grad_(True)
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(buffers[name])


class AdversarialTrainStep:
    """`step(state, inputs, targets, generator) -> (state, outputs)`.

    Args:
        g_forward: `(g_model, inputs, generator) -> fakes` (a tensor or a
            tuple whose first element D sees, through `d_forward`).
        d_forward: `(d_model, images_or_fakes) -> logits or list of logits`.
        recon_loss_fn: `(fakes, targets) -> scalar`.
        g_loss_fn: `(fake_logits) -> scalar`, the adversarial generator loss.
        d_loss_fn: `(real_logits, fake_logits) -> scalar`.
        adv_weight: weight of the adversarial term in G's loss.
        ema_decay: keep `state.g_ema_params` (seed it with copies of G's
            parameters, `init_adversarial_state(..., ema=True)`).
        mesh: a `parallel.Mesh`; the inputs are then this rank's rows of the
            global batch over "data".
        spatial_shard_axis: with a mesh, the inputs' axis cut over "space"
            (2, the outermost spatial axis), run under `spatial_cut`; a
            "space" axis of more than one rank needs it.

    `outputs` is keyed by AdversarialKeys (reals, fakes, the reconstruction,
    generator and discriminator losses) and "loss", G's total.
    """

    def __init__(
        self,
        g_forward: Callable,
        d_forward: Callable,
        recon_loss_fn: Callable,
        g_loss_fn: Callable,
        d_loss_fn: Callable,
        adv_weight: float = 1.0,
        ema_decay: float | None = None,
        mesh: Mesh | None = None,
        spatial_shard_axis: int | None = None,
    ) -> None:
        self.mesh = check_mesh(mesh, spatial_shard_axis)
        self.spatial_shard_axis = spatial_shard_axis
        self.g_forward = g_forward
        self.d_forward = d_forward
        self.recon_loss_fn = recon_loss_fn
        self.g_loss_fn = g_loss_fn
        self.d_loss_fn = d_loss_fn
        self.adv_weight = adv_weight
        self.ema_decay = ema_decay

    def __call__(
        self,
        state: AdversarialTrainState,
        inputs: torch.Tensor,
        targets: torch.Tensor,
        generator: torch.Generator | None = None,
    ) -> tuple[AdversarialTrainState, dict]:
        with placement(self.mesh, self.spatial_shard_axis):
            return self._step(state, inputs, targets, generator)

    def _reduce(self, model: nn.Module, *losses: torch.Tensor) -> None:
        if self.mesh is not None:
            reduce_over_mesh_([p.grad for p in model.parameters() if p.grad is not None]
                              + [loss.reshape(1) for loss in losses], self.mesh)

    def _step(self, state, inputs, targets, generator):
        g, d = state.g_model, state.d_model
        # generator phase: D as it was, no gradient into it
        state.g_optimizer.zero_grad(set_to_none=True)
        fakes = self.g_forward(g, inputs, generator)
        with frozen(d):
            fake_logits = self.d_forward(d, fakes)
        recon_loss = self.recon_loss_fn(fakes, targets)
        adv_loss = self.g_loss_fn(fake_logits)
        g_total = recon_loss + self.adv_weight * adv_loss
        g_total.backward()
        recon_loss, adv_loss, g_total = (t.detach().clone()
                                         for t in (recon_loss, adv_loss, g_total))
        self._reduce(g, recon_loss, adv_loss, g_total)
        state.g_optimizer.step()

        # discriminator phase: reals, then the detached fakes
        fakes_detached = detach(fakes)
        state.d_optimizer.zero_grad(set_to_none=True)
        real_logits = self.d_forward(d, inputs)
        fake_logits = self.d_forward(d, fakes_detached)
        d_total = self.d_loss_fn(real_logits, fake_logits)
        d_total.backward()
        d_total = d_total.detach().clone()
        self._reduce(d, d_total)
        state.d_optimizer.step()

        g_ema = state.g_ema_params
        if self.ema_decay is not None:
            if g_ema is None:
                raise ValueError(
                    "ema_decay is set but state.g_ema_params is None — seed it with "
                    "init_adversarial_state(..., ema=True)"
                )
            ema_update_(g, g_ema, state.step, self.ema_decay)

        outputs = {
            AdversarialKeys.REALS: inputs,
            AdversarialKeys.FAKES: fakes_detached,
            AdversarialKeys.RECONSTRUCTION_LOSS: recon_loss,
            AdversarialKeys.GENERATOR_LOSS: adv_loss,
            AdversarialKeys.DISCRIMINATOR_LOSS: d_total,
            "loss": g_total,
        }
        return state._replace(step=state.step + 1, g_ema_params=g_ema), outputs


def make_adversarial_train_step(
    g_forward: Callable,
    d_forward: Callable,
    recon_loss_fn: Callable,
    g_loss_fn: Callable,
    d_loss_fn: Callable,
    adv_weight: float = 1.0,
    ema_decay: float | None = None,
    mesh: Mesh | None = None,
    spatial_shard_axis: int | None = None,
) -> AdversarialTrainStep:
    """Build the fused G + D step; see `AdversarialTrainStep`. The optimizers
    (the JAX function's `g_tx`, `d_tx`) live in the state."""
    return AdversarialTrainStep(
        g_forward, d_forward, recon_loss_fn, g_loss_fn, d_loss_fn, adv_weight, ema_decay, mesh,
        spatial_shard_axis,
    )


def init_adversarial_state(
    g_model: nn.Module,
    g_optimizer: torch.optim.Optimizer,
    d_model: nn.Module,
    d_optimizer: torch.optim.Optimizer,
    ema: bool = False,
) -> AdversarialTrainState:
    """The initial state; `ema=True` seeds g_ema_params with copies of G's
    parameters."""
    g_ema = {n: p.detach().clone() for n, p in g_model.named_parameters()} if ema else None
    return AdversarialTrainState(g_model, g_optimizer, d_model, d_optimizer, 0, g_ema)


class AdversarialTrainer:
    """Epoch and iteration loop around the adversarial step.

    Args:
        train_data_loader: iterable of (inputs, targets) pairs or of inputs
            (then targets = inputs).
        max_epochs: number of epochs to run.
        g_forward ... adv_weight, ema_decay: see `AdversarialTrainStep`.
        initial_state: the AdversarialTrainState (its g_ema_params seeded
            here when ema_decay is set and it has none).
        handlers: AdversarialIterationEvents (or "iteration_completed" /
            "epoch_completed") -> `callback(trainer, outputs)`. After each
            step every event fires in its declared order with the step's
            outputs, then "iteration_completed"; "epoch_completed" after each
            epoch, as the JAX trainer fires them.
        generator: the step's sampling draws (default: torch's default
            generator).
    """

    def __init__(
        self,
        train_data_loader,
        max_epochs: int,
        g_forward: Callable,
        d_forward: Callable,
        recon_loss_function: Callable,
        g_loss_function: Callable,
        d_loss_function: Callable,
        initial_state: AdversarialTrainState,
        adv_weight: float = 1.0,
        handlers: dict | None = None,
        generator: torch.Generator | None = None,
        ema_decay: float | None = None,
    ) -> None:
        self.data_loader = train_data_loader
        self.max_epochs = max_epochs
        self.state = initial_state
        self.handlers = handlers or {}
        self.generator = generator
        self.iteration = 0
        self.epoch = 0
        self.output: dict | None = None
        self._step = make_adversarial_train_step(
            g_forward, d_forward, recon_loss_function, g_loss_function, d_loss_function,
            adv_weight=adv_weight, ema_decay=ema_decay,
        )
        if ema_decay is not None and initial_state.g_ema_params is None:
            self.state = initial_state._replace(g_ema_params={
                n: p.detach().clone() for n, p in initial_state.g_model.named_parameters()
            })

    def _fire(self, event, outputs) -> None:
        cb = self.handlers.get(event)
        if cb is not None:
            cb(self, outputs)

    def run(self) -> AdversarialTrainState:
        for _ in range(self.max_epochs):
            self.epoch += 1
            for batch in self.data_loader:
                if isinstance(batch, (tuple, list)) and len(batch) == 2:
                    inputs, targets = batch
                else:
                    inputs = targets = batch
                self.state, outputs = self._step(self.state, inputs, targets, self.generator)
                self.output = outputs
                self.iteration += 1
                for event in AdversarialIterationEvents:
                    self._fire(event, outputs)
                self._fire("iteration_completed", outputs)
            self._fire("epoch_completed", self.output)
        return self.state
