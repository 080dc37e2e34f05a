"""EMA vector quantisation, channels-first.

Counterpart of generativemodels_tpu/networks/layers/vector_quantizer.py:
`EMAQuantizer` and `VectorQuantizer`. The JAX module keeps its codebook in a
mutable flax collection; here `embedding.weight` (K, D), `ema_cluster_size`
(K,) and `ema_w` (K, D) are buffers under the reference torch keys
(`quantizer.quantizer.embedding.weight`, ...), updated in place under
`torch.no_grad()` when the quantizer is called with `train=True` (by default
when the module is in training mode). The distances are computed in float32
whatever the input type, and the output passes the gradient straight
through to the input. `distributed_synchronization` all-reduces the
statistics over the mesh axis `axis_name` when `ddp_sync` is set and a
mesh is current (`with mesh:`, parallel/mesh.py; the train steps built
with a mesh enter it), as the JAX module's psum over a bound axis, and
over "space" under a spatial cut (what the JAX step's GSPMD sums over a
"data" x "space" batch); it is the identity otherwise. The commitment loss
is a `cut_mean`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.spatial import cut_mean

__all__ = ["EMAQuantizer", "VectorQuantizer"]


class _Codebook(nn.Module):
    """Holds the codebook as the buffer `weight`, so that its key is the
    reference's `embedding.weight` and no optimizer sees it."""

    def __init__(self, weight: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("weight", weight)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


class EMAQuantizer(nn.Module):
    """Nearest-codebook quantisation with EMA codebook updates.

    Takes and returns (B, D, *spatial); indices are (B, *spatial).
    `embedding_init` "normal" draws N(0, 1), "kaiming_uniform" U(+-sqrt(3/D)).
    """

    def __init__(
        self,
        spatial_dims: int,
        num_embeddings: int,
        embedding_dim: int,
        commitment_cost: float = 0.25,
        decay: float = 0.99,
        epsilon: float = 1e-5,
        embedding_init: str = "normal",
        ddp_sync: bool = True,
        axis_name: str | None = None,
    ) -> None:
        super().__init__()
        self.ddp_sync = ddp_sync
        self.axis_name = axis_name
        self.spatial_dims = spatial_dims
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.commitment_cost = commitment_cost
        self.decay = decay
        self.epsilon = epsilon
        if embedding_init == "kaiming_uniform":
            bound = math.sqrt(3.0 / embedding_dim)
            weight = torch.empty(num_embeddings, embedding_dim).uniform_(-bound, bound)
        else:
            weight = torch.randn(num_embeddings, embedding_dim)
        self.embedding = _Codebook(weight)
        self.register_buffer("ema_cluster_size", torch.zeros(num_embeddings))
        self.register_buffer("ema_w", weight.clone())

    def quantize(self, inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, D, *spatial) -> (flat input (N, D) f32, one-hot (N, K) f32,
        indices (B, *spatial)); the nearest code by float32 distance, the
        first of equals."""
        x = _channels_last(inputs)
        flat = x.reshape(-1, self.embedding_dim).float()
        embedding = self.embedding.weight
        distances = (
            (flat**2).sum(dim=1, keepdim=True)
            + (embedding**2).sum(dim=1)[None, :]
            - 2.0 * flat @ embedding.t()
        )
        indices = torch.argmax(-distances, dim=1)
        encodings = F.one_hot(indices, self.num_embeddings).float()
        return flat, encodings, indices.reshape(x.shape[:-1])

    def embed(self, embedding_indices: torch.Tensor) -> torch.Tensor:
        """Indices (B, *spatial) -> codes (B, D, *spatial)."""
        return _channels_first(self.embedding.weight[embedding_indices])

    def distributed_synchronization(
        self, encodings_sum: torch.Tensor, dw: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sums over the ranks of the current mesh's `axis_name` (the JAX
        module's psum), when `ddp_sync` is set and a mesh with that axis is
        current, and over the slabs of a spatial cut; else the identity."""
        from ...parallel.collectives import all_reduce
        from ...parallel.mesh import current_mesh
        from ...parallel.spatial import current_spatial_cut

        mesh, cut = current_mesh(), current_spatial_cut()
        names = ([self.axis_name] if self.ddp_sync and self.axis_name is not None
                 and mesh is not None and self.axis_name in mesh.shape else [])
        if cut is not None:
            mesh = cut.mesh
            names.append(cut.axis)
        if not names:
            return encodings_sum, dw
        group = mesh.group(tuple(names))
        return all_reduce(encodings_sum, group), all_reduce(dw, group)

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, encodings: torch.Tensor) -> None:
        encodings_sum, dw = self.distributed_synchronization(
            encodings.sum(dim=0), encodings.t() @ flat
        )
        cluster_size = self.ema_cluster_size * self.decay + encodings_sum * (1 - self.decay)
        n = cluster_size.sum()
        weights = (cluster_size + self.epsilon) / (n + self.num_embeddings * self.epsilon) * n
        ema_w = self.ema_w * self.decay + dw * (1 - self.decay)
        self.ema_cluster_size.copy_(cluster_size)
        self.ema_w.copy_(ema_w)
        self.embedding.weight.copy_(ema_w / weights[:, None])

    def forward(
        self, inputs: torch.Tensor, train: bool | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (quantized, commitment loss, indices). The codes are those of
        the codebook before this call's update; `train` (default: training
        mode) applies the EMA update."""
        flat, encodings, indices = self.quantize(inputs)
        quantized = self.embed(indices).to(inputs.dtype)
        if self.training if train is None else train:
            self._ema_update(flat, encodings)
        loss = self.commitment_cost * cut_mean((quantized.detach() - inputs) ** 2)
        # straight-through estimator
        quantized = inputs + (quantized - inputs).detach()
        return quantized, loss, indices


class VectorQuantizer(nn.Module):
    """Wraps an EMAQuantizer; keeps the last call's codebook perplexity in
    `self.perplexity`."""

    def __init__(self, quantizer: EMAQuantizer) -> None:
        super().__init__()
        self.quantizer = quantizer
        self.perplexity: torch.Tensor | None = None

    def forward(
        self, inputs: torch.Tensor, train: bool | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (commitment loss, quantized)."""
        quantized, loss, indices = self.quantizer(inputs, train=train)
        counts = torch.bincount(indices.reshape(-1), minlength=self.quantizer.num_embeddings)
        avg_probs = counts.float() / indices.numel()
        self.perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
        return loss, quantized

    def embed(self, embedding_indices: torch.Tensor) -> torch.Tensor:
        return self.quantizer.embed(embedding_indices)

    def quantize(self, encodings: torch.Tensor) -> torch.Tensor:
        """Codebook indices of (B, D, *spatial), with no update."""
        return self.quantizer.quantize(encodings)[2]
