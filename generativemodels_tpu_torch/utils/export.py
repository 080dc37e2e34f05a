"""Export of samplers and forward steps for serving, through `torch.export`.

Counterpart of generativemodels_tpu/utils/export.py: a sampler or forward
step is traced into one graph, kernels included, serialised as a `.pt2`
file (`torch.export.save`), and reloaded and called in a serving process
without the Python code that built the model. The kernels are
`torch.library` ops (`gmtpu_torch::*`), so the graph records them by name;
`load_fn` imports `generativemodels_tpu_torch.ops` to register them and
builds no network.

Unlike `jax.export`, the graph cannot hold a random generator: a sampler
exported here takes its noise as input (`recipes/serve.py` draws it from
the seeded generator in the order the in-process sampler does). Python
control flow is unrolled: a DDIM-50 chain is fifty UNet forwards in one
graph. The graph runs the same ATen operations as the eager module, so on
the same inputs its outputs are the eager module's to the bit.
"""
from __future__ import annotations

import io
from typing import Callable

import torch
from torch import nn


class _Function(nn.Module):
    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class ExportedFunction:
    """A reloaded export: call it with tensors like the example arguments.

    `input_specs` lists (shape, dtype, device) of each input, as exported.
    """

    def __init__(self, program: torch.export.ExportedProgram) -> None:
        self.program = program
        self._module = program.module()
        names = set(program.graph_signature.user_inputs)
        self.input_specs = [
            (tuple(node.meta["val"].shape), node.meta["val"].dtype, node.meta["val"].device)
            for node in program.graph.nodes if node.op == "placeholder" and node.name in names
        ]

    def __call__(self, *args):
        return self._module(*args)


def export_program(fn: Callable | nn.Module, *example_args) -> torch.export.ExportedProgram:
    """Trace `fn` (a module, or a function of tensors with its weights
    closed over) at the example arguments' shapes and dtypes."""
    module = fn if isinstance(fn, nn.Module) else _Function(fn)
    return torch.export.export(module, tuple(example_args))


def export_fn(fn: Callable | nn.Module, *example_args) -> bytes:
    """Serialise `fn` specialised to the example arguments; reload with `load_fn`."""
    buf = io.BytesIO()
    torch.export.save(export_program(fn, *example_args), buf)
    return buf.getvalue()


def load_fn(blob: bytes) -> ExportedFunction:
    """Reload an exported function from its bytes."""
    from .. import ops  # noqa: F401  (registers the gmtpu_torch ops)

    return ExportedFunction(torch.export.load(io.BytesIO(blob)))


def save_exported(path: str, fn: Callable | nn.Module,
                  *example_args) -> torch.export.ExportedProgram:
    """Export `fn` to `path` (a `.pt2` file); returns the exported program."""
    program = export_program(fn, *example_args)
    torch.export.save(program, path)
    return program


def load_exported(path: str) -> ExportedFunction:
    with open(path, "rb") as f:
        return load_fn(f.read())
