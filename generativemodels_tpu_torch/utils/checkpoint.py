"""Checkpoints of training state as `torch.save` files.

Counterpart of generativemodels_tpu/utils/checkpoint.py, with its API
(`save`, `restore`, `latest_step`, `all_steps`, `max_to_keep`, `close`)
and no orbax: each step is one file, `<directory>/step_<step>.pt`, written
under a temporary name and renamed, so a reader never sees half a file. A
state is any tree of dicts, lists and tuples over tensors, numbers,
`nn.Module`s and optimizers (the last two saved as their state dicts);
files are read back with `weights_only=True`. A NamedTuple (`TrainState`,
`GuardState`) is saved as a dict of its fields, since `weights_only`
refuses its class, and is rebuilt as the template's type on restore, as
the JAX manager restores a pytree into its template's structure.

The JAX module's `migrate_legacy_conv_params` has no counterpart: it
remaps a flax tree of the JAX package's first round, and the port's state
dicts carry the reference's own keys.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import torch
from torch import nn

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _plain(state: Any) -> Any:
    """`state` with modules and optimizers replaced by their state dicts."""
    if isinstance(state, (nn.Module, torch.optim.Optimizer)):
        return state.state_dict()
    if isinstance(state, torch.Tensor):
        return state.detach()
    if _is_namedtuple(state):
        return {f: _plain(v) for f, v in zip(state._fields, state)}
    if isinstance(state, dict):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_plain(v) for v in state)
    return state


def _like(template: Any, value: Any) -> Any:
    """`value` shaped as `template`: tensors take the template tensor's dtype
    and device, modules and optimizers load the value as their state dict
    (and are returned), other leaves are the value as read."""
    if isinstance(template, (nn.Module, torch.optim.Optimizer)):
        template.load_state_dict(value)
        return template
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value).to(dtype=template.dtype, device=template.device)
    if _is_namedtuple(template):
        return type(template)(*(_like(t, value[f]) for f, t in zip(template._fields, template)))
    if isinstance(template, dict):
        return {k: _like(template[k], value[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(t, v) for t, v in zip(template, value))
    return value


class CheckpointManager:
    """Save and restore train-state trees under one directory.

    Args:
        directory: checkpoint root (created if missing).
        max_to_keep: how many of the newest steps stay on disk.
    """

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save `state` at `step`; as orbax, a step not past the latest one is
        skipped (returns False) unless `force`, which overwrites it."""
        latest = self.latest_step()
        if not force and latest is not None and int(step) <= latest:
            return False
        fd, tmp = tempfile.mkstemp(suffix=".pt.tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(_plain(state), tmp)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, step: int | None = None, template: Any | None = None) -> Any:
        """Read the tree at `step` (default: latest) onto the CPU.

        With `template` (a like-structured tree) tensors take its dtypes and
        devices and its modules and optimizers load what was saved for them.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        value = torch.load(self._path(step), map_location="cpu", weights_only=True)
        return value if template is None else _like(template, value)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _NAME.match(name)))

    def close(self) -> None:
        """Nothing to flush: every save is complete when it returns."""
