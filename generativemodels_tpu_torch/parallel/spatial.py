"""The spatial cut: one spatial axis of every feature map split over "space".

The JAX package shards a volume's axis over the mesh's "space" axis and
lets GSPMD insert what the cut needs (tests/test_parallel.py:78-95,
484-620): halo exchanges for the convolutions, all-reduced norm
statistics, sequence-parallel attention, global means. Under
`spatial_cut(mesh)` the port's layers do the same by hand. Each rank holds
one slab of axis 2 (H, the outermost spatial axis of (B, C, H, W[, D])),
the slabs in rank order along "space".

Ownership rule. Every rank but the last holds the same number of planes,
L; the last holds the rest of the axis, which may be fewer, or none. A
cut volume starts even (L = T / n). A window operation of stride s (a
convolution, a pooling) gives each rank but the last the L / s outputs
whose windows start in its slab (s must divide L), and the last rank the
rest of the uncut output; a transposed convolution of stride s gives each
rank but the last L * s outputs and the last the rest. Every output plane
is computed once, by one rank, and a layer whose output is not T / s
planes long (the PatchGAN's stride-1 layers shrink each axis by one)
stays inside the rule: the last rank's slab shrinks. What the rule cannot
serve raises: a stride that does not divide L, a last slab that an output
needs more of than exists, a rank between the first and the last whose
slab is thinner than the halo it must send (its neighbour would need
planes two ranks away). Each rank checks what it holds, so where only some
ranks raise the others wait in the next collective until the launcher
ends the world.

- `ConvND` and the PatchGAN's convolutions (`halo_conv`) take from their
  neighbours the planes their kernel, stride and padding reach across the
  cut (`ppermute`, whose backward returns the halo gradients); the outer
  borders, and a last slab shorter than the halo it owes, are zeros.
  `ConvTransposeND` (`halo_conv_transpose`) takes the input planes its
  kernel, stride, padding and output padding reach. The nearest upsample
  stays local.
- `GroupNorm` and the PatchGAN's instance norm normalise with the mean
  and the two-pass variance of sums (f32 at least) and counts all-reduced over
  "space" (`collectives.global_mean_var`), BatchNorm with flax's E[x] and
  E[x^2] (`collectives.global_moments`), as each computes them uncut;
  BatchNorm and the EMA codebook also over "data" where they sync over it.
- A loss that is a mean over a cut tensor is `cut_mean`: this rank's sum
  over the element count of the whole space group, so that the ranks'
  shares add up to the uncut mean (the steps sum them with the gradients).
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

from .collectives import _reduce, ppermute

__all__ = [
    "SpatialCut",
    "current_spatial_cut",
    "cut_mean",
    "halo_conv",
    "halo_conv_transpose",
    "halo_extend",
    "halo_window",
    "spatial_cut",
]

CUT_DIM = 2
_CONV_FN = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_TRANSPOSE_FN = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


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

    @property
    def last(self) -> bool:
        return self.index == self.n - 1


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


def cut_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of x; under a spatial cut, this rank's
    share of the uncut tensor's mean: its sum (in f32 at least) over the
    element count of the whole space group (all-reduced), in x's type (on
    a "space" axis of one rank, nothing is cut: the mean). The shares of the
    ranks add up to the uncut mean, and each one's gradient is this rank's
    part of the mean's: the steps sum both over the ranks
    (`parallel.train.reduce_over_mesh_`). Per-rank means are never
    averaged, since the PatchGAN's slabs need not be equal."""
    cut = current_spatial_cut()
    if cut is None:
        return torch.mean(x)
    count = _reduce(torch.tensor([float(x.numel())], dtype=torch.float64, device=x.device),
                    cut.group)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return (xf.sum() / count.to(xf.dtype)).reshape(()).to(x.dtype)


def _send_planes(x: torch.Tensor, dim: int, count: int, tail: bool) -> torch.Tensor:
    """The first (`tail` False) or last `count` planes of x along `dim`;
    zeros make up a slab that holds fewer (behind its planes, or in front
    for the last ones)."""
    length = x.shape[dim]
    if length >= count:
        return x.narrow(dim, length - count if tail else 0, count)
    shape = list(x.shape)
    shape[dim] = count - length
    pad = x.new_zeros(shape)
    return torch.cat([pad, x] if tail else [x, pad], dim)


def halo_extend(
    x: torch.Tensor, before: int, after: int, cut: SpatialCut, border: str = "zeros"
) -> tuple[torch.Tensor, int]:
    """x's slab with `before` planes of the previous rank's slab in front
    and `after` of the next one's behind, along the cut axis.

    At the outer border the missing planes are zeros (`border="zeros"`) or
    left out (`border="none"`). The first rank's and the last rank's slabs
    may be thinner than the halo they send (the planes past them lie
    outside the uncut axis: zeros); a rank between them must hold it.
    Returns (extended x, planes put in front). Differentiable: the gradient
    of a halo plane goes back to its owner, and a halo left out stays in
    the graph at zero weight, since its backward is a collective that
    every rank takes part in.
    """
    d, n, r, group = cut.dim, cut.n, cut.index, cut.group
    length = x.shape[d]
    if n > 2 and not cut.last and (before > length or after > length):
        raise ValueError(
            f"a slab of {length} planes cannot feed a halo of {before} + {after} planes "
            f"across {n} ranks"
        )
    parts, left_out = [], []
    lo = 0
    if before:
        prev = ppermute(_send_planes(x, d, before, tail=True), group,
                        [(i, i + 1) for i in range(n - 1)])
        if r > 0 or border == "zeros":
            parts.append(prev)
            lo = before
        else:
            left_out.append(prev)
    parts.append(x)
    if after:
        nxt = ppermute(_send_planes(x, d, after, tail=False), group,
                       [(i + 1, i) for i in range(n - 1)])
        (parts if r < n - 1 or border == "zeros" else left_out).append(nxt)
    out = torch.cat(parts, d) if len(parts) > 1 else x
    for halo in left_out:
        if halo.requires_grad:
            out = out + 0 * halo.sum()
    return out, lo


def halo_window(
    x: torch.Tensor, extent: int, stride: int, padding: int, cut: SpatialCut, pad_after: int = 0
) -> tuple[torch.Tensor, int]:
    """The slab extended (or trimmed) so that a window of `extent` planes
    moved by `stride`, with no padding on the cut axis, gives this rank's
    outputs of the uncut operation (zero padding `padding` on both ends and
    `pad_after` more zero planes at the end), and their number.

    Returns (extended x, outputs): a rank but the last gets L / s outputs
    from `padding` planes of its previous neighbour (zeros on the first
    rank) and `extent - stride - padding` of its next; the last rank gets
    the rest of the uncut output, its slab ending in the padding's zeros.
    The extended slab of a last rank that owns no output is padded to one
    window, and the caller keeps 0 of its outputs: every rank then takes
    part in the same halo exchanges, forward and backward.
    """
    d, length = cut.dim, x.shape[cut.dim]
    after = extent - stride - padding
    if not cut.last and length % stride:
        raise ValueError(
            f"a window of stride {stride} takes slabs that it divides; this rank holds "
            f"{length} planes"
        )
    x, _ = halo_extend(x, padding, max(after, 0), cut)
    if not cut.last:  # a window skips the last -after planes when after < 0
        return (x.narrow(d, 0, padding + length + after) if after < 0 else x), length // stride
    # the last rank: the planes past its slab are the end padding's zeros
    # (the zeros halo_extend received stay in the graph, so that the backward
    # of every halo exchange runs on every rank)
    total = padding + length + padding + pad_after
    count = (total - extent) // stride + 1
    if count < 0:
        raise ValueError(
            f"a window of {extent} planes (stride {stride}, padding {padding}) leaves the last "
            f"slab of {length} planes an output the rank before it computed: the uncut output "
            f"ends inside the previous slab"
        )
    want = max(total, extent)
    if x.shape[d] >= want:
        return x.narrow(d, 0, want), count
    shape = list(x.shape)
    shape[d] = want - x.shape[d]
    return torch.cat([x, x.new_zeros(shape)], d), count


def halo_conv(conv: torch.nn.Module, x: torch.Tensor, weight, bias, cut: SpatialCut,
              pad_after: int = 0):
    """`conv`'s convolution (a torch ConvNd's stride, padding, dilation) of
    the cut tensor x, with `weight` and `bias` as given; `pad_after` zero
    planes end the uncut axis before the convolution's own padding.

    The rank computes the output planes the ownership rule gives it
    (`halo_window`): with padding p, stride s and kernel extent e along the
    cut axis it needs p planes from the previous rank and e - s - p from
    the next (zeros at the border), and the cut axis's padding is then 0.
    """
    if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
        raise ValueError("a cut convolution takes integer zero padding")
    d = cut.dim - 2
    extent = conv.dilation[d] * (conv.weight.shape[2 + d] - 1) + 1
    x, count = halo_window(x, extent, conv.stride[d], conv.padding[d], cut, pad_after)
    padding = list(conv.padding)
    padding[d] = 0
    y = _CONV_FN[x.ndim - 2](x, weight, bias, conv.stride, padding, conv.dilation, conv.groups)
    return y if y.shape[cut.dim] == count else y.narrow(cut.dim, 0, count)


def halo_conv_transpose(conv: torch.nn.Module, x: torch.Tensor, weight, bias,
                        cut: SpatialCut) -> torch.Tensor:
    """`conv`'s transposed convolution (a torch ConvTransposeNd's stride,
    padding, output padding, dilation) of the cut tensor x.

    Output plane o takes input plane i through tap j where o = i s - p + j
    dil. A rank but the last owns the L s output planes from its slab's
    start times s; they take the input planes from floor((e - 1 - p) / s)
    before its slab to ceil(p / s) after it (e = dil (k - 1) + 1). The last
    rank owns the rest of the uncut output: (R - 1) s - 2 p + e +
    output_padding planes from its R. The rank runs the transposed
    convolution unpadded on its extended slab, crops its planes, pads with
    zeros the output padding's planes that no input reaches, and adds the
    bias.
    """
    d = cut.dim - 2
    k = conv.weight.shape[2 + d]
    s, p, op, dil = conv.stride[d], conv.padding[d], conv.output_padding[d], conv.dilation[d]
    extent = dil * (k - 1) + 1
    before = max(0, (extent - 1 - p) // s)
    after = -(-p // s)
    length = x.shape[cut.dim]
    x, lo = halo_extend(x, before, after, cut)
    count = length * s if not cut.last else (length - 1) * s - 2 * p + extent + op
    if count < 0:
        raise ValueError(f"a transposed convolution leaves the last slab of {length} planes "
                         f"no output")
    padding, output_padding = list(conv.padding), list(conv.output_padding)
    padding[d] = output_padding[d] = 0
    y = _CONV_TRANSPOSE_FN[x.ndim - 2](x, weight, None, conv.stride, padding, output_padding,
                                       conv.groups, conv.dilation)
    first = lo * s + p
    short = first + count - y.shape[cut.dim]
    if short > 0:
        shape = list(y.shape)
        shape[cut.dim] = short
        y = torch.cat([y, y.new_zeros(shape)], cut.dim)
    y = y.narrow(cut.dim, first, count)
    return y if bias is None else y + bias.reshape(-1, *([1] * (y.ndim - 2)))
