"""Transformer MLP block with GELU / GEGLU activations.

Counterpart of generativemodels_tpu/networks/blocks/mlp.py (the MONAI
`MLPBlock` that the reference's BasicTransformerBlock uses with
act="GEGLU"). The GELU is the tanh approximation, as flax's `nn.gelu`
computes it by default (torch's default is the exact erf form).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


class MLPBlock(nn.Module):
    """Linear -> (GELU | GEGLU) -> Dropout -> Linear -> Dropout.

    For GEGLU the first projection doubles the width and its second half
    gates the first: out = x * gelu(gate). `dtype` is the computation type
    of both projections (parameters stay float32).
    """

    def __init__(
        self,
        hidden_size: int,
        mlp_dim: int,
        act: str = "GELU",
        dropout_rate: float = 0.0,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        self.act = act.upper()
        if self.act not in ("GELU", "GEGLU"):
            raise ValueError(f"Unsupported MLP activation: {act}")
        width = mlp_dim * 2 if self.act == "GEGLU" else mlp_dim
        self.linear1 = Linear(hidden_size, width, dtype=dtype)
        self.linear2 = Linear(mlp_dim, hidden_size, dtype=dtype)
        self.drop1 = nn.Dropout(dropout_rate)
        self.drop2 = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear1(x)
        if self.act == "GEGLU":
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate, approximate="tanh")
        else:
            h = F.gelu(h, approximate="tanh")
        return self.drop2(self.linear2(self.drop1(h)))
