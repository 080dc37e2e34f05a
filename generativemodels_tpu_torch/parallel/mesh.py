"""Named axes over the processes, and what each rank holds.

Counterpart of generativemodels_tpu/parallel/mesh.py. The JAX package lays
its devices out as a `jax.sharding.Mesh` and lets XLA insert collectives;
here each process is one rank, `create_mesh` lays the ranks out row-major
over named axes ("data", "space") exactly as the JAX function reshapes its
device list, and gives each axis a process subgroup: the ranks that differ
only in their index along it. A rank holds its own piece of every global
tensor (`Sharding.shard`), and the steps reduce over the subgroups
themselves (`parallel/train.py`).

`with mesh:` makes the mesh current, as `with mesh:` does for JAX: the
layers with cross-device statistics (the EMA codebook, the synced
BatchNorm) reduce over its axes only while it is current.
"""
from __future__ import annotations

import contextvars
import itertools
import math
from collections.abc import Sequence
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .multihost import process_count, process_device, process_index

__all__ = [
    "Mesh",
    "Sharding",
    "batch_sharding",
    "create_mesh",
    "current_mesh",
    "draw_local",
    "replicated",
    "shard_batch",
    "shard_params",
    "spatial_sharding",
]

_CURRENT: contextvars.ContextVar["Mesh | None"] = contextvars.ContextVar(
    "gmtpu_torch_mesh", default=None
)


def current_mesh() -> "Mesh | None":
    """The mesh of the innermost `with mesh:` (None outside one)."""
    return _CURRENT.get()


class Mesh:
    """Ranks laid out over named axes; one subgroup an axis.

    Attributes: `shape` (axis name -> size), `axis_names`, `size` (ranks),
    `rank`, `coords` (this rank's index along each axis), `device` (this
    rank's device). `group(axis)` is the subgroup of the ranks that share
    every other coordinate (None without a process group); `group(("data",
    "space"))` is the whole mesh's.
    """

    def __init__(self, shape: dict[str, int], device: torch.device) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(shape.values())
        self.rank = process_index()
        self.device = device
        strides = [math.prod(list(shape.values())[i + 1:]) for i in range(len(shape))]
        self.coords = {a: (self.rank // s) % shape[a] for a, s in zip(self.axis_names, strides)}
        self._groups: dict[str, object] = {}
        self._tokens: list = []
        if not dist.is_initialized():
            return
        # every rank creates every subgroup, in the same order
        for axis, stride in zip(self.axis_names, strides):
            others = [range(shape[a]) for a in self.axis_names if a != axis]
            for rest in itertools.product(*others):
                base = sum(
                    c * s for c, s in zip(rest, [s for a, s in zip(self.axis_names, strides)
                                                 if a != axis])
                )
                ranks = [base + i * stride for i in range(shape[axis])]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    def group(self, axes: str | Sequence[str]):
        """The subgroup of the ranks that differ only along `axes` (one
        axis name, or several: the axes of more than one rank among them
        must be one axis or span the mesh, as "data" and "space" do)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for axis in names:
            if axis not in self.shape:
                raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        cut = [a for a in names if self.shape[a] > 1]
        if len(cut) <= 1:
            return self._groups.get(cut[0] if cut else names[0])
        if set(cut) != {a for a, n in self.shape.items() if n > 1}:
            raise ValueError(f"no subgroup spans the axes {cut} of mesh {self.shape}")
        return dist.group.WORLD if dist.is_initialized() else None

    def index(self, axis: str) -> int:
        return self.coords[axis] if axis in self.coords else 0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def __enter__(self) -> "Mesh":
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._tokens.pop())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def create_mesh(
    axis_shapes: Sequence[int] | dict[str, int] | None = None,
    axis_names: Sequence[str] = ("data", "space"),
    device: str | torch.device | None = None,
) -> Mesh:
    """A mesh over every process of the group (one process without one).

    Args:
        axis_shapes: sizes per axis (dict name -> size, or a sequence with
            `axis_names`). Defaults to every process on one "data" axis.
        axis_names: names when axis_shapes is a sequence.
        device: this rank's device (default `cuda:LOCAL_RANK`; "cpu" for a
            gloo group).
    """
    n = process_count()
    if axis_shapes is None:
        shape = {"data": n}
    elif isinstance(axis_shapes, dict):
        shape = dict(axis_shapes)
    else:
        shape = dict(zip(tuple(axis_names)[: len(axis_shapes)], axis_shapes))
    if math.prod(shape.values()) != n:
        raise ValueError(
            f"mesh shape {tuple(shape.values())} needs {math.prod(shape.values())} devices, "
            f"have {n}"
        )
    return Mesh(shape, process_device(device))


@dataclass(frozen=True)
class Sharding:
    """Which axis of a global tensor each mesh axis cuts (`spec`, JAX's
    PartitionSpec: one mesh-axis name or None a tensor axis)."""

    mesh: Mesh
    spec: tuple

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the global tensor x."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.axis_size(axis)
            if x.shape[dim] % n:
                raise ValueError(
                    f"axis {dim} of shape {tuple(x.shape)} does not divide over {axis!r} ({n})"
                )
            x = x.chunk(n, dim)[self.mesh.index(axis)]
        return x


def batch_sharding(mesh: Mesh, ndim: int, data_axis: str = "data") -> Sharding:
    """Axis 0 (batch) cut over the data axis; the rest whole."""
    return Sharding(mesh, (data_axis,) + (None,) * (ndim - 1))


def spatial_sharding(
    mesh: Mesh,
    ndim: int,
    data_axis: str = "data",
    space_axis: str = "space",
    spatial_axis_index: int = 2,
) -> Sharding:
    """Batch cut over `data` and one spatial axis over `space` (for (B, C, H,
    W, D) volumes the default cuts H, the outermost)."""
    spec = [None] * ndim
    spec[0] = data_axis if data_axis in mesh.shape else None
    spec[spatial_axis_index] = space_axis
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    """Every rank holds the whole tensor (parameters, scalars)."""
    return Sharding(mesh, ())


def draw_local(draw, shape) -> torch.Tensor:
    """This rank's piece of a random draw: `draw(global_shape)` for a
    tensor of this rank's `shape`. While a mesh is current (`with mesh:`)
    the global batch's tensor is drawn (axis 0 times the "data" size, and
    under an even spatial cut axis 2 times the "space" size) and the rank
    keeps its rows and slab, so that every rank draws what the
    single-device step draws from the same generator; outside a mesh,
    `draw(shape)`."""
    from .spatial import current_spatial_cut

    mesh = current_mesh()
    if mesh is None:
        return draw(tuple(shape))
    cut = current_spatial_cut()
    spec = ["data" if "data" in mesh.shape else None] + [None] * (len(shape) - 1)
    full = [shape[0] * mesh.axis_size("data"), *shape[1:]]
    if cut is not None:
        spec[cut.dim] = cut.axis
        full[cut.dim] *= cut.n
    return Sharding(mesh, tuple(spec)).shard(draw(tuple(full)))


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(batch, mesh: Mesh, data_axis: str = "data"):
    """This rank's rows of a global batch (a tensor or a tree of them)."""
    return _tree_map(lambda x: batch_sharding(mesh, x.ndim, data_axis).shard(x), batch)


@torch.no_grad()
def shard_params(params, mesh: Mesh):
    """Rank 0's parameters on every rank: a module's parameters and buffers,
    or a tree of tensors, broadcast in place. Returns `params`."""
    if not dist.is_initialized():
        return params
    tensors = (
        list(params.parameters()) + list(params.buffers())
        if isinstance(params, torch.nn.Module)
        else []
    )
    if not tensors:
        _tree_map(tensors.append, params)
    for t in tensors:
        dist.broadcast(t.data, src=0)
    return params
