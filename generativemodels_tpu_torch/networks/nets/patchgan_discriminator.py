"""Pix2PixHD patch discriminators, channels-first.

Counterpart of generativemodels_tpu/networks/nets/patchgan_discriminator.py:
`PatchDiscriminator` (a strided conv stack whose forward returns every
intermediate feature map with the prediction last) and
`MultiScalePatchDiscriminator`. Children keep the reference torch names
(`initial_conv`, `0`, `1`, ..., `final_conv`, each conv as `.conv`, each
norm as `.adn.N`; `discriminator_{i}` in the multi-scale one), so
networks/convert.py maps JAX parameters and BatchNorm statistics onto them.

The norms compute what the JAX module's do:
- "BATCH": flax `BatchNorm(momentum=0.9, epsilon=1e-5)`, i.e. torch momentum
  0.1; in training mode the batch statistics (the variance as
  E[x^2] - E[x]^2, biased, in float32) normalise and move the running
  statistics, in eval mode (the JAX module's `deterministic`) the running
  statistics normalise. Its scale is drawn from N(0, 0.02), as the JAX
  module initialises it.
- "INSTANCE": no affine, the biased variance, eps 1e-5.
- "GROUP": GroupNorm with affine; `("GROUP", {"num_groups": n, "eps": e})`.
Norm kwargs that the JAX module would drop without a word raise ValueError.
Convolutions take symmetric padding and N(0, 0.02) weights; the prediction
is cast to float32.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["PatchDiscriminator", "MultiScalePatchDiscriminator"]

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
# the norm kwargs the JAX module reads, by kind
_NORM_KWARGS = {"BATCH": (), "INSTANCE": (), "GROUP": ("num_groups", "eps")}


def _activation(act):
    if act is None:
        return lambda x: x
    if isinstance(act, (tuple, list)):
        name, kwargs = act[0], (act[1] if len(act) > 1 else {})
    else:
        name, kwargs = act, {}
    name = str(name).upper()
    if name == "LEAKYRELU":
        slope = kwargs.get("negative_slope", 0.01)
        return lambda x: F.leaky_relu(x, slope)
    if name == "RELU":
        return F.relu
    if name == "TANH":
        return torch.tanh
    if name == "SIGMOID":
        return torch.sigmoid
    raise ValueError(f"Unsupported activation {act}")


def _norm_kind(norm) -> tuple[str, dict]:
    kind, kwargs = norm, {}
    if isinstance(norm, (tuple, list)):
        kind, kwargs = norm[0], dict(norm[1]) if len(norm) > 1 else {}
    kind = str(kind).upper()
    if kind not in _NORM_KWARGS:
        raise ValueError(f"Unsupported norm {norm}")
    unknown = sorted(set(kwargs) - set(_NORM_KWARGS[kind]))
    if unknown:
        raise ValueError(f"norm {kind} takes no {unknown} (accepted: {_NORM_KWARGS[kind]})")
    return kind, kwargs


class BatchNormND(nn.BatchNorm1d):
    """flax BatchNorm over (B, C, *spatial) of any rank: torch momentum 0.1,
    the fast biased variance in the running statistics (torch keeps the
    unbiased one), normalisation in float32."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.ndim < 2:
            raise ValueError(f"expected (B, C, *spatial), got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.float()
        if self.training:
            axes = [0, *range(2, x.ndim)]
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class _InstanceNorm(nn.Module):
    """(x - mean) / sqrt(var + 1e-5) over each sample's and channel's spatial
    axes (biased variance; a single voxel normalises to 0, where
    F.instance_norm refuses it in training mode)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(2, x.ndim))
        var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5)


class _ADN(nn.Module):
    """Norm (child `N`), dropout, activation: the reference's ADN ordering."""

    def __init__(self, norm, channels: int, dropout: float, act) -> None:
        super().__init__()
        kind, kwargs = _norm_kind(norm)
        if kind == "BATCH":
            self.N = BatchNormND(channels, eps=1e-5, momentum=0.1)
            nn.init.normal_(self.N.weight, 0.0, 0.02)
        elif kind == "INSTANCE":
            self.N = _InstanceNorm()
        else:
            self.N = nn.GroupNorm(kwargs.get("num_groups", min(32, channels)), channels,
                                  eps=kwargs.get("eps", 1e-5))
        self.D = nn.Dropout(dropout)
        self.act = _activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.D(self.N(x)))


class _Conv(nn.Module):
    """A conv with N(0, 0.02) weights, then (unless `adn` is None) norm,
    dropout and activation."""

    def __init__(self, spatial_dims, c_in, c_out, kernel, stride, padding, bias,
                 adn: _ADN | None = None) -> None:
        super().__init__()
        self.conv = _CONV[spatial_dims](c_in, c_out, kernel, stride=stride, padding=padding,
                                        bias=bias)
        nn.init.normal_(self.conv.weight, 0.0, 0.02)
        if bias:
            nn.init.zeros_(self.conv.bias)
        self.adn = adn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.adn(x) if self.adn is not None else x


class PatchDiscriminator(nn.Module):
    """Strided conv stack, channels doubling, final conv head.

    `forward` returns the list of intermediate features with the prediction
    (float32) as the last element (for feature-matching losses).
    """

    def __init__(
        self,
        spatial_dims: int,
        num_channels: int,
        in_channels: int,
        out_channels: int = 1,
        num_layers_d: int = 3,
        kernel_size: int = 4,
        activation=("LEAKYRELU", {"negative_slope": 0.2}),
        norm="BATCH",
        bias: bool = False,
        padding: int | Sequence[int] = 1,
        dropout: float = 0.0,
        last_conv_kernel_size: int | None = None,
    ) -> None:
        super().__init__()
        act = _activation(activation)
        last_k = last_conv_kernel_size or kernel_size
        self.initial_conv = _Conv(spatial_dims, in_channels, num_channels, kernel_size, 2,
                                  padding, True)
        self.initial_drop = nn.Dropout(dropout)
        self.act = act
        c_in, c_out = num_channels, num_channels * 2
        self.num_layers_d = num_layers_d
        for l in range(num_layers_d):
            stride = 1 if l == num_layers_d - 1 else 2
            self.add_module(str(l), _Conv(
                spatial_dims, c_in, c_out, kernel_size, stride, padding, bias,
                adn=_ADN(norm, c_out, dropout, activation),
            ))
            c_in, c_out = c_out, c_out * 2
        self.final_conv = _Conv(spatial_dims, c_in, out_channels, last_k, 1, (last_k - 1) // 2,
                                True)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = self.act(self.initial_drop(self.initial_conv(x)))
        outs = [h]
        for l in range(self.num_layers_d):
            h = getattr(self, str(l))(h)
            outs.append(h)
        outs.append(self.final_conv(h).float())
        return outs


class MultiScalePatchDiscriminator(nn.Module):
    """Several PatchDiscriminators over progressively pooled inputs.

    `forward` returns `(outputs, intermediate_features)`: one prediction and
    one feature list per discriminator. With a `pooling_method`,
    discriminator i sees the input average-pooled i times (window
    `kernel_size`, stride 2, zero padding (k - 1) // 2 counted in the mean).
    """

    def __init__(
        self,
        num_d: int,
        num_layers_d: int | Sequence[int],
        spatial_dims: int,
        num_channels: int,
        in_channels: int,
        pooling_method: str | None = None,
        out_channels: int = 1,
        kernel_size: int = 4,
        activation=("LEAKYRELU", {"negative_slope": 0.2}),
        norm="BATCH",
        bias: bool = False,
        dropout: float = 0.0,
        minimum_size_im: int = 256,
        last_conv_kernel_size: int = 1,
    ) -> None:
        super().__init__()
        if isinstance(num_layers_d, int):
            if pooling_method is None:
                num_layers = [num_layers_d * i for i in range(1, num_d + 1)]
            else:
                num_layers = [num_layers_d] * num_d
        else:
            num_layers = list(num_layers_d)
        if len(num_layers) != num_d:
            raise ValueError("num_d must match the length of num_layers_d")
        self.num_d = num_d
        self.pooling_method = pooling_method
        self.kernel_size = kernel_size
        self.padding = (kernel_size - 1) // 2
        for i, n_layers in enumerate(num_layers):
            if float(minimum_size_im) / (2**n_layers) < 1:
                raise AssertionError(
                    f"Image size too small for discriminator {i} with num_layers {n_layers}"
                )
            self.add_module(f"discriminator_{i}", PatchDiscriminator(
                spatial_dims=spatial_dims, num_channels=num_channels, in_channels=in_channels,
                out_channels=out_channels, num_layers_d=n_layers, kernel_size=kernel_size,
                activation=activation, norm=norm, bias=bias, padding=self.padding,
                dropout=dropout, last_conv_kernel_size=last_conv_kernel_size,
            ))

    def forward(self, x: torch.Tensor) -> tuple[list[torch.Tensor], list[list[torch.Tensor]]]:
        outputs, features = [], []
        for i in range(self.num_d):
            inp = x
            if self.pooling_method is not None:
                for _ in range(i):
                    inp = _AVG_POOL[x.ndim - 2](inp, self.kernel_size, stride=2,
                                                padding=self.padding, count_include_pad=True)
            outs = getattr(self, f"discriminator_{i}")(inp)
            outputs.append(outs[-1])
            features.append(outs[:-1])
        return outputs, features
