"""SPADE (spatially-adaptive) normalisation, channels-first.

Counterpart of generativemodels_tpu/networks/blocks/spade_norm.py: a
parameter-free (or, for the UNet, affine GroupNorm) base norm, then
`normalized * (1 + gamma(seg)) + beta(seg)`, gamma and beta from a shared
conv tower over the segmentation map resized to the input's spatial shape.
An instance norm follows the gamma and beta convs (the reference's MONAI
`Convolution` default). Keys as the reference's: `mlp_shared`, `mlp_gamma`,
`mlp_beta` (`.conv.weight`), and `param_free_norm.N` for an affine base
GroupNorm (an ADN wrapper's norm child).

`resize_nearest` takes torch's `F.interpolate(mode="nearest")` index rule,
src = floor(dst * in / out), which the JAX module copies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .convolutions import ConvND
from .layers import GroupNorm


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free instance norm over the spatial axes of (B, C, *spatial)."""
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def resize_nearest(x: torch.Tensor, spatial_shape) -> torch.Tensor:
    """Nearest-neighbour resize of (B, C, *spatial), src = floor(dst * in / out)
    on each axis (torch's "nearest")."""
    for axis, out_s in enumerate(spatial_shape, start=2):
        in_s = x.shape[axis]
        if in_s != out_s:
            idx = torch.floor(torch.arange(out_s, device=x.device, dtype=torch.float32)
                              * (in_s / out_s)).long()
            x = torch.index_select(x, axis, idx)
    return x


class SPADE(nn.Module):
    """Segmentation-conditioned normalisation of (B, norm_nc, *spatial).

    Args:
        label_nc: channels of the segmentation map.
        norm_nc: channels normalised.
        kernel_size: kernel of the tower's convs.
        spatial_dims: 2 or 3.
        hidden_channels: width of the shared conv.
        norm: the base norm, "INSTANCE" (parameter-free) or "GROUP";
            `norm_params` as the reference's norm factory reads them:
            GROUP takes `num_groups` (32), `eps` (`norm_eps`) and `affine`
            (True: learned scale and bias, flax's GroupNorm; False:
            parameter-free), INSTANCE takes `eps` and no affine.
        norm_eps: eps of the base norm, unless `norm_params` sets one, and
            of the instance norms after the gamma and beta convs.
        dtype: computation type of the convs and the affine GroupNorm.
    """

    def __init__(
        self,
        label_nc: int,
        norm_nc: int,
        kernel_size: int = 3,
        spatial_dims: int = 2,
        hidden_channels: int = 64,
        norm: str = "INSTANCE",
        norm_params: dict | None = None,
        norm_eps: float = 1e-5,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        params = norm_params or {}
        self.kind = str(norm).upper()
        self.norm_eps = norm_eps
        self.base_eps = params.get("eps", norm_eps)
        self.num_groups = params.get("num_groups", 32)
        if self.kind == "GROUP":
            if params.get("affine", True):
                self.param_free_norm = nn.ModuleDict(
                    {"N": GroupNorm(self.num_groups, norm_nc, self.base_eps, dtype=dtype)}
                )
            else:
                self.param_free_norm = None
        elif self.kind == "INSTANCE":
            if params.get("affine", False):
                raise ValueError(
                    "affine INSTANCE SPADE base norm is not supported "
                    "(the reference never constructs it; torch InstanceNorm "
                    "defaults to affine=False)"
                )
            self.param_free_norm = None
        else:
            raise ValueError(f"Unsupported SPADE base norm: {norm}")
        pad = kernel_size // 2
        self.mlp_shared = ConvND(spatial_dims, label_nc, hidden_channels, kernel_size,
                                 padding=pad, dtype=dtype)
        self.mlp_gamma = ConvND(spatial_dims, hidden_channels, norm_nc, kernel_size,
                                padding=pad, dtype=dtype)
        self.mlp_beta = ConvND(spatial_dims, hidden_channels, norm_nc, kernel_size,
                               padding=pad, dtype=dtype)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        if self.param_free_norm is not None:
            normalized = self.param_free_norm["N"](x)
        elif self.kind == "GROUP":
            normalized = F.group_norm(x, self.num_groups, eps=self.base_eps)
        else:
            normalized = instance_norm(x, self.base_eps)
        segmap = resize_nearest(segmap, x.shape[2:])
        actv = F.leaky_relu(self.mlp_shared(segmap), negative_slope=0.01)
        gamma = instance_norm(self.mlp_gamma(actv), self.norm_eps)
        beta = instance_norm(self.mlp_beta(actv), self.norm_eps)
        return normalized * (1.0 + gamma) + beta
