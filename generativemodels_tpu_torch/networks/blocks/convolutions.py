"""N-D convolution wrapper and resampling helpers, channels-first.

Counterpart of generativemodels_tpu/networks/blocks/convolutions.py.
`ConvND` is a `torch.nn.Conv{1,2,3}d` with torch-style symmetric padding,
held as the child `conv` so that its keys read `<name>.conv.weight`, as in
the reference's MONAI `Convolution`. Its `dtype` mirrors the JAX module's
casts: parameters stay float32, input and kernel are cast to `dtype`, and
the bias is cast and added after the convolution. The JAX module's TPU
lowerings (the depth-tap 3D decomposition and the fused upsample-conv)
compute the same function and have no counterpart here.

`ConvTransposeND` wraps `torch.nn.ConvTranspose{1,2,3}d` the same way. Its
weight (I, O, *k) is applied as the adjoint of a convolution; the JAX
module's kernel (*k, I, O) runs through `lax.conv_transpose` without
`transpose_kernel`, so a kernel carried between the two is transposed and
flipped on every spatial axis (networks/convert.py).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import compute_dtype

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_CONV_TRANSPOSE = {1: nn.ConvTranspose1d, 2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_TRANSPOSE_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


class ConvND(nn.Module):
    """Convolution over `spatial_dims` spatial axes of (B, C, *spatial).

    Args:
        spatial_dims: 1, 2 or 3.
        in_channels: input channels.
        features: output channels.
        kernel_size, strides, padding, dilation: int or per-axis tuple;
            padding is symmetric, torch-style.
        bias: add a bias term (the JAX module's `use_bias`).
        zero_init: zero the weight and bias (the reference `zero_module`).
        nearest_upsample: upsample the input x2 (nearest-neighbour) first.
        dtype: computation type (e.g. torch.bfloat16); None computes in the
            promotion of the input's type and float32.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        features: int,
        kernel_size: int | Sequence[int] = 3,
        strides: int | Sequence[int] = 1,
        padding: int | Sequence[int] = 0,
        zero_init: bool = False,
        nearest_upsample: bool = False,
        dtype: torch.dtype | None = None,
        dilation: int | Sequence[int] = 1,
        bias: bool = True,
    ) -> None:
        super().__init__()
        self.conv = _CONV[spatial_dims](
            in_channels, features, kernel_size, stride=strides, padding=padding,
            dilation=dilation, bias=bias,
        )
        if zero_init:
            nn.init.zeros_(self.conv.weight)
            if bias:
                nn.init.zeros_(self.conv.bias)
        self.nearest_upsample = nearest_upsample
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = self.conv.weight, self.conv.bias
        dtype = compute_dtype(self.dtype, x, weight)
        x = x.to(dtype)
        if self.nearest_upsample:
            x = upsample_nearest(x, 2)
        if dtype == weight.dtype:
            return self.conv(x)
        y = self.conv._conv_forward(x, weight.to(dtype), None)
        return y if bias is None else y + bias.to(dtype).reshape(-1, *([1] * (x.ndim - 2)))


class ConvTransposeND(nn.Module):
    """Transposed convolution over `spatial_dims` spatial axes of (B, C, *spatial).

    Output size per axis, torch's arithmetic: (n - 1) * stride - 2 * padding
    + dilation * (k - 1) + 1 + output_padding. As in the JAX module, input
    and kernel are cast to `dtype` (None: the input's type) and the bias is
    cast and added after the transposed convolution.
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        features: int,
        kernel_size: int | Sequence[int] = 3,
        strides: int | Sequence[int] = 1,
        padding: int | Sequence[int] = 0,
        output_padding: int | Sequence[int] = 0,
        dilation: int | Sequence[int] = 1,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.conv = _CONV_TRANSPOSE[spatial_dims](
            in_channels, features, kernel_size, stride=strides, padding=padding,
            output_padding=output_padding, dilation=dilation,
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        if dtype == conv.weight.dtype:
            return conv(x)
        y = _CONV_TRANSPOSE_FN[x.ndim - 2](
            x, conv.weight.to(dtype), None, conv.stride, conv.padding, conv.output_padding,
            conv.groups, conv.dilation,
        )
        return y + conv.bias.to(dtype).reshape(-1, *([1] * (x.ndim - 2)))


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """Average pooling (stride = window) over the spatial axes of (B, C, *spatial)."""
    return _AVG_POOL[x.ndim - 2](x, window)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour x`scale` upsampling of (B, C, *spatial)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")
