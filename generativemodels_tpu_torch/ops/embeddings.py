"""Sinusoidal timestep embeddings.

Counterpart of generativemodels_tpu/ops/embeddings.py (DDPM-style,
cos-first concatenation).
"""
from __future__ import annotations

import math

import torch


def get_timestep_embedding(
    timesteps: torch.Tensor, embedding_dim: int, max_period: int = 10000
) -> torch.Tensor:
    """Sinusoidal embeddings of (N,) integer timesteps -> (N, embedding_dim) f32.

    Layout: [cos(args), sin(args)] with frequencies
    exp(-log(max_period) * i / half_dim), zero-padded when dim is odd.
    """
    if timesteps.ndim != 1:
        raise ValueError("Timesteps should be a 1d-array")

    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / half_dim)

    args = timesteps[:, None].float() * freqs[None, :]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    if embedding_dim % 2 == 1:
        embedding = torch.nn.functional.pad(embedding, (0, 1))
    return embedding
