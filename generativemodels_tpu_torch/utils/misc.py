"""Broadcasting helpers shared by schedulers and inferers.

Counterpart of generativemodels_tpu/utils/misc.py (unsqueeze_right/left).
"""
from __future__ import annotations

import torch


def unsqueeze_right(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append size-1 axes to `x` until it has `ndim` dimensions.

    Broadcasts per-batch scalar coefficients (e.g. sqrt(alpha_bar_t))
    against image tensors of shape (B, C, *spatial).
    """
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def unsqueeze_left(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Prepend size-1 axes to `x` until it has `ndim` dimensions."""
    return x.reshape((1,) * (ndim - x.ndim) + x.shape)
