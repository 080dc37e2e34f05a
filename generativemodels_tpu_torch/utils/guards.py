"""Failure detection: NaN/Inf guards for training steps.

Counterpart of generativemodels_tpu/utils/guards.py. The JAX guard picks
the old or the new state inside jit after the step; a torch step updates
its model and optimizer in place, so the guard copies every tensor the
state holds before the step and copies them back when the loss is not
finite. That costs one copy of the state and one host read of the loss a
step, and only where the guard is on: an unguarded step is unchanged.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple

import torch
from torch import nn


class GuardState(NamedTuple):
    inner: Any  # the wrapped train state (a TrainState, module, optimizer or tree of them)
    skipped: int  # count of skipped (non-finite) steps


def _snapshot(state: Any) -> Callable[[], None]:
    """Copy what `state` holds now; the returned function puts it back in place."""
    if isinstance(state, nn.Module):
        saved = {k: v.detach().clone() for k, v in state.state_dict().items()}
        return lambda: state.load_state_dict(saved)
    if isinstance(state, torch.optim.Optimizer):
        # deep: its first step creates the moment buffers, which a restore drops again
        saved = copy.deepcopy(state.state_dict())
        return lambda: state.load_state_dict(saved)
    if isinstance(state, torch.Tensor):
        saved = state.detach().clone()
        return lambda: state.data.copy_(saved)
    if isinstance(state, dict):
        restores = [_snapshot(v) for v in state.values()]
    elif isinstance(state, (list, tuple)):
        restores = [_snapshot(v) for v in state]
    else:  # ints and other immutable leaves: the old state object keeps them
        return lambda: None

    def restore() -> None:
        for r in restores:
            r()

    return restore


def guard_nans(step_fn: Callable) -> Callable:
    """Wrap `step_fn(state, *args) -> (state, loss)` with a finite check.

    When the returned loss is non-finite, every tensor of the state is
    restored to its value before the step, the old state object is
    returned and `skipped` increments; training continues from the previous
    state instead of poisoning the parameters.
    """

    def guarded(gstate: GuardState, *args):
        restore = _snapshot(gstate.inner)
        new_inner, loss = step_fn(gstate.inner, *args)
        if bool(torch.isfinite(loss).all()):
            return GuardState(new_inner, gstate.skipped), loss
        restore()
        return GuardState(gstate.inner, gstate.skipped + 1), loss

    return guarded


def init_guard(state: Any) -> GuardState:
    return GuardState(inner=state, skipped=0)
