"""Standard-normal draws in the order a recipe makes them.

The JAX recipes split a key for each draw; the port's draw from one
`torch.Generator` in a fixed order, which each recipe's docstring states.
Given `noise` (tensors in that order), a recipe takes them in place of the
generator's draws, so a caller can hand both frameworks the same noise.
"""
from __future__ import annotations

from typing import Iterable

import torch


class Draws:
    """`normal(shape, dtype)`: the next tensor of `noise` when given, else a
    draw from `generator` (one seeded with 0 on `device` by default)."""

    def __init__(self, device: torch.device | str, generator: torch.Generator | None = None,
                 noise: Iterable[torch.Tensor] | None = None) -> None:
        self.device = torch.device(device)
        self._noise = iter(noise) if noise is not None else None
        if generator is None and noise is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.generator = generator

    def normal(self, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self._noise is not None:
            value = next(self._noise)
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f"injected noise {tuple(value.shape)} for a draw of {shape}")
            return value.to(device=self.device, dtype=dtype)
        return torch.randn(shape, generator=self.generator, device=self.device, dtype=dtype)
