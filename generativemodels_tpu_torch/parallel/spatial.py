"""The spatial cut: one spatial axis of every feature map split over "space".

The JAX package shards a volume's axis over the mesh's "space" axis and
lets GSPMD insert what the cut needs (tests/test_parallel.py:78-95,
484-620): halo exchanges for the convolutions, all-reduced GroupNorm
statistics, sequence-parallel attention. Under `spatial_cut(mesh)` the
port's layers do the same by hand. Each rank holds one slab of axis 2 (H,
the outermost spatial axis of (B, C, H, W[, D])), the slabs in rank order
along "space", all of one depth:

- `ConvND` (`halo_conv`) takes from its neighbours the planes its kernel,
  stride and padding reach across the cut (`ppermute`, whose backward
  returns the halo gradients); only the first and last rank pad the outer
  border with zeros. A stride-2 conv needs an even slab, and raises
  otherwise; the nearest upsample stays local.
- `GroupNorm` normalises with the mean and E[x^2] of f32 sums all-reduced
  over "space" (`collectives.global_moments`).
- The attention levels go through `ops.sharded_attention`: with H
  outermost, a rank's flattened tokens are one contiguous block of the
  sequence. A cross-attention context stays replicated.
- The fused 3D ResnetBlock (kernel 5) folds the global statistics into its
  affine and runs the kernel on the slab extended by its halo planes
  (`halo_extend`), then crops: the function the uncut call computes.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .collectives import ppermute

__all__ = [
    "SpatialCut",
    "current_spatial_cut",
    "halo_conv",
    "halo_extend",
    "spatial_cut",
]

CUT_DIM = 2
_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@dataclass(frozen=True)
class SpatialCut:
    mesh: object
    axis: str = "space"
    dim: int = CUT_DIM

    @property
    def n(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.index(self.axis)

    @property
    def group(self):
        return self.mesh.group(self.axis)


_CUT: contextvars.ContextVar[SpatialCut | None] = contextvars.ContextVar(
    "gmtpu_torch_spatial_cut", default=None
)


def current_spatial_cut() -> SpatialCut | None:
    """The cut in force (None outside `spatial_cut`, or on a "space" axis
    of one rank, where nothing is cut)."""
    cut = _CUT.get()
    return cut if cut is not None and cut.n > 1 else None


@contextlib.contextmanager
def spatial_cut(mesh, axis: str = "space", dim: int = CUT_DIM):
    """Run the layers on slabs of axis `dim` cut over the mesh axis `axis`.

    Self-attention then goes through `sequence_sharding(mesh, axis)` (the
    allgather) unless a sequence sharding is already in force. Only the outermost
    spatial axis (2) is cut: the attention levels' tokens of a rank are then
    one block of the sequence (the JAX package takes any axis).
    """
    from ..ops.sharded_attention import current_sequence_sharding, sequence_sharding

    if dim != CUT_DIM:
        raise ValueError(f"the spatial cut takes axis {CUT_DIM} (the outermost), got {dim}")
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    token = _CUT.set(SpatialCut(mesh, axis, dim))
    try:
        with contextlib.ExitStack() as stack:
            if current_sequence_sharding() is None:
                stack.enter_context(sequence_sharding(mesh, axis=axis))
            yield
    finally:
        _CUT.reset(token)


def halo_extend(
    x: torch.Tensor, before: int, after: int, cut: SpatialCut, border: str = "zeros"
) -> tuple[torch.Tensor, int]:
    """x's slab with `before` planes of the previous rank's slab in front
    and `after` of the next one's behind, along the cut axis.

    At the outer border the missing planes are zeros (`border="zeros"`) or
    left out (`border="none"`). Returns (extended x, planes put in front).
    Differentiable: the gradient of a halo plane goes back to its owner.
    """
    d, n, r, group = cut.dim, cut.n, cut.index, cut.group
    length = x.shape[d]
    if before > length or after > length:
        raise ValueError(
            f"a slab of {length} planes cannot feed a halo of {before} + {after} planes"
        )
    parts = []
    lo = 0
    if before:
        prev = ppermute(x.narrow(d, length - before, before), group,
                        [(i, i + 1) for i in range(n - 1)])
        if r > 0 or border == "zeros":
            parts.append(prev)
            lo = before
    parts.append(x)
    if after:
        nxt = ppermute(x.narrow(d, 0, after), group, [(i + 1, i) for i in range(n - 1)])
        if r < n - 1 or border == "zeros":
            parts.append(nxt)
    return (torch.cat(parts, d) if len(parts) > 1 else x), lo


def halo_conv(conv: torch.nn.Module, x: torch.Tensor, weight, bias, cut: SpatialCut,
              pad_after: int = 0):
    """`conv`'s convolution (a torch ConvNd's stride, padding, dilation) of
    the cut tensor x, with `weight` and `bias` as given; `pad_after` zero
    planes end the uncut axis before the convolution's own padding.

    The rank computes the output rows of its own slab: with padding p,
    stride s and kernel extent e along the cut axis it needs p planes from
    the previous rank and e - s - p from the next (zeros at the border),
    and the cut axis's padding is then 0.
    """
    if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
        raise ValueError("a cut convolution takes integer zero padding")
    d = cut.dim - 2
    k = conv.weight.shape[2 + d]
    s, p, dil = conv.stride[d], conv.padding[d], conv.dilation[d]
    extent = dil * (k - 1) + 1
    length = x.shape[cut.dim]
    total = length * cut.n
    if length % s or (total + pad_after + 2 * p - extent) // s + 1 != total // s:
        raise ValueError(
            f"a convolution (kernel {k}, stride {s}, padding {p}) of {total} planes cut into "
            f"slabs of {length} does not give each rank its slab's outputs"
        )
    after = extent - s - p
    if after < 0:
        x = x.narrow(cut.dim, 0, length + after)
        after = 0
    x, _ = halo_extend(x, p, after, cut)
    padding = list(conv.padding)
    padding[d] = 0
    return _CONV_FN[x.ndim - 2](x, weight, bias, conv.stride, padding, conv.dilation, conv.groups)
