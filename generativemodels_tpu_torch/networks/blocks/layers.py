"""Linear, GroupNorm and LayerNorm with a compute dtype, as flax's nn.Dense,
nn.GroupNorm and nn.LayerNorm.

The JAX package builds its blocks from flax layers whose `dtype` sets the
computation type over float32 parameters. These subclasses keep torch's
modules and state-dict keys and add the same `dtype`:

- `Linear`: input, weight and bias cast to `dtype`; the bias is added after
  the product, in `dtype`, as flax adds it. `bias=False` is flax's
  `use_bias=False`.
- `GroupNorm`, `LayerNorm`: statistics and normalisation in float32 (flax
  reduces in float32 whatever the input type), the result cast to `dtype`.
  Both default to flax's epsilon, 1e-6 (torch's is 1e-5). Under a spatial
  cut (parallel/spatial.py) GroupNorm takes the mean and then the variance
  of the centred values over every slab (two all-reduces), the two-pass
  variance that F.group_norm takes uncut: flax's E[x^2] - E[x]^2 cancels
  in its gradient where a group's mean is far above its spread.

With `dtype=None` they compute in float32, as flax promotes to the float32
parameters.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.collectives import global_mean_var
from ...parallel.spatial import current_spatial_cut


def compute_dtype(dtype: torch.dtype | None, x: torch.Tensor, param: torch.Tensor) -> torch.dtype:
    """`dtype`, else the promotion of the input's and the parameter's types."""
    return dtype or torch.promote_types(x.dtype, param.dtype)


class Linear(nn.Linear):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        dtype: torch.dtype | None = None,
        bias: bool = True,
    ) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self.dtype, x, self.weight)
        if dtype == self.weight.dtype:
            return F.linear(x.to(dtype), self.weight, self.bias)
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return y if self.bias is None else y + self.bias.to(dtype)


class GroupNorm(nn.GroupNorm):
    def __init__(
        self,
        num_groups: int,
        num_channels: int,
        eps: float = 1e-6,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__(num_groups, num_channels, eps=eps, affine=True)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cut = current_spatial_cut()
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if cut is None:
            y = F.group_norm(xf, self.num_groups, self.weight.to(xf.dtype),
                             self.bias.to(xf.dtype), self.eps)
        else:  # statistics over every slab of the cut (parallel/spatial.py)
            xg = xf.reshape(x.shape[0], self.num_groups, -1)
            mean, var = global_mean_var(xg, (2,), cut.group)
            rstd = torch.rsqrt(var + self.eps)
            y = ((xg - mean[..., None]) * rstd[..., None]).reshape(x.shape)
            affine = (1, -1) + (1,) * (x.ndim - 2)
            y = y * self.weight.reshape(affine) + self.bias.reshape(affine)
        return y.to(compute_dtype(self.dtype, x, self.weight))


class LayerNorm(nn.LayerNorm):
    def __init__(
        self, num_features: int, eps: float = 1e-6, dtype: torch.dtype | None = None
    ) -> None:
        super().__init__(num_features, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(compute_dtype(self.dtype, x, self.weight))
