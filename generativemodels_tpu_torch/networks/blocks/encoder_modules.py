"""Conditioning-image rescaler.

Counterpart of generativemodels_tpu/networks/blocks/encoder_modules.py
(`SpatialRescaler`): an optional 1x1 channel mapper, then `n_stages`
resamplings by `F.interpolate`, which the JAX module re-implements
(nearest with the floor rule, linear without antialias, bicubic with
a = -0.75, area as an adaptive average pool). As in JAX, `size` resamples
to that shape (the coordinate scale in / out) and `multiplier` to
floor(in * multiplier) with the scale 1 / multiplier, torch's
`scale_factor` semantics. torch's bicubic takes 2D inputs only.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .convolutions import ConvND

_METHODS = ("nearest", "linear", "bilinear", "trilinear", "bicubic", "area")
_LINEAR = {1: "linear", 2: "bilinear", 3: "trilinear"}


class SpatialRescaler(nn.Module):
    """Interpolation-based resizer for (B, C, *spatial) conditioning images."""

    def __init__(
        self,
        spatial_dims: int = 2,
        n_stages: int = 1,
        size: Sequence[int] | int | None = None,
        method: str = "bilinear",
        multiplier: Sequence[float] | float | None = None,
        in_channels: int = 3,
        out_channels: int | None = None,
        bias: bool = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        if n_stages < 0:
            raise ValueError("n_stages must be >= 0")
        if method not in _METHODS:
            raise ValueError(f"method must be one of {sorted(_METHODS)}")
        if size is not None and n_stages != 1:
            raise ValueError("when size is not None, n_stages should be 1.")
        if size is not None and multiplier is not None:
            raise ValueError("only one of size or multiplier should be defined.")
        self.spatial_dims = spatial_dims
        self.n_stages = n_stages
        self.size = size
        self.multiplier = multiplier
        linear = method in ("linear", "bilinear", "trilinear")
        self.mode = _LINEAR[spatial_dims] if linear else method
        self.channel_mapper = (
            ConvND(spatial_dims, in_channels, out_channels, kernel_size=1, bias=bias, dtype=dtype)
            if out_channels is not None else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        n = self.spatial_dims
        kwargs = {} if self.mode in ("nearest", "area") else {"align_corners": False}
        for _ in range(self.n_stages):
            if self.size is not None:
                size = (self.size,) * n if isinstance(self.size, int) else tuple(self.size)
                x = F.interpolate(x, size=size, mode=self.mode, **kwargs)
            elif self.multiplier is not None:
                mult = self.multiplier
                mults = (float(mult),) * n if isinstance(mult, (int, float)) else tuple(
                    float(m) for m in mult)
                x = F.interpolate(x, scale_factor=mults, mode=self.mode, **kwargs)
        return x

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)
