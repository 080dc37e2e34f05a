"""Several processes, one rank each: the process group, file partitions and
the global batch.

Counterpart of generativemodels_tpu/parallel/multihost.py. The JAX package
starts `jax.distributed` and assembles per-host batches into one global
array; here every process is one rank of a `torch.distributed` process
group (`nccl` on the card, `gloo` when the caller asks for the CPU), holds
its own rows on its own device, and the "global batch" is the concatenation
of the ranks' rows in rank order. The reference launches its DDP tutorial
with torchrun (ddpm_training_ddp.py:105-125); so does the port:

    torchrun --nproc_per_node=8 -m generativemodels_tpu_torch.recipes.train_2d_ddpm \\
        --data-parallel --data-dir DIR --batch 512

and across hosts the same command on every host with `--nnodes`,
`--node_rank` and `--master_addr`, or with `--multihost` and
GMTPU_COORD / GMTPU_NPROC / GMTPU_RANK set on each.
"""
from __future__ import annotations

import datetime
import os
import warnings
from typing import Iterable, Iterator, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "assemble_global_batch",
    "global_batches",
    "initialize_multihost",
    "partition_files",
    "process_count",
    "process_device",
    "process_index",
]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


# partition_files' arguments shadow the two names
_process_index, _process_count = process_index, process_count


def process_device(device: str | torch.device | None = None) -> torch.device:
    """The device this rank computes on: `cuda:LOCAL_RANK` (torchrun sets
    LOCAL_RANK; cuda:0 without it), or `device` when the caller names one
    (e.g. "cpu")."""
    if device is not None and str(device) != "cuda":
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    timeout: float = 600.0,
    backend: str | None = None,
) -> tuple[int, int]:
    """Join (or start) the process group; returns (process_index, count).

    The arguments resolve in this order: explicit arguments; then
    GMTPU_COORD / GMTPU_NPROC / GMTPU_RANK; then torchrun's MASTER_ADDR,
    MASTER_PORT, RANK and WORLD_SIZE; then a single process, with the JAX
    function's warning. The coordinator is `host:port` (a TCP store) or any
    `torch.distributed` init method (`file://...`). The backend follows the
    device: `gloo` where `device` is "cpu", else `nccl` with this rank on
    `cuda:LOCAL_RANK`, unless `backend` names one (`gloo` takes CUDA
    tensors too, and ranks that share a card, where `nccl` refuses them).
    Where a coordinator was given and the group does not
    come up within `timeout` seconds, this raises. Calling it again once the
    group is up returns its rank and size.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()

    coordinator_address = coordinator_address or os.environ.get("GMTPU_COORD")
    if num_processes is None and "GMTPU_NPROC" in os.environ:
        num_processes = int(os.environ["GMTPU_NPROC"])
    if process_id is None and "GMTPU_RANK" in os.environ:
        process_id = int(os.environ["GMTPU_RANK"])
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
        if num_processes is None and "WORLD_SIZE" in os.environ:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None and "RANK" in os.environ:
            process_id = int(os.environ["RANK"])

    if coordinator_address is None:
        warnings.warn(
            "initialize_multihost: no coordinator (arguments, GMTPU_COORD or torchrun's "
            "MASTER_ADDR); continuing as a SINGLE process. If this is one of several "
            "hosts, each would otherwise train independently on the full dataset: pass "
            "coordinator_address/num_processes/process_id, set GMTPU_COORD/GMTPU_NPROC/"
            "GMTPU_RANK, or launch with torchrun.",
            UserWarning,
            stacklevel=2,
        )
        return 0, 1
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without the process count and rank"
        )

    cpu = process_device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(process_device(device))
    backend = backend or ("gloo" if cpu else "nccl")
    dist.init_process_group(
        backend,
        init_method=_init_method(coordinator_address),
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
        # nccl binds its communicator to this rank's card
        **({"device_id": process_device(device)} if backend == "nccl" else {}),
    )
    return dist.get_rank(), dist.get_world_size()


def partition_files(
    paths: Sequence[str],
    process_index: int | None = None,
    process_count: int | None = None,
) -> list[str]:
    """Deterministic per-process slice of a (globally identical) file list.

    Strided assignment after truncating to a multiple of the process count,
    so every process holds exactly the same number of files: each then runs
    the same number of steps an epoch and the collectives stay in lockstep
    (a ragged tail would hang the group). The reference's
    partition_dataset(even_divisible=True) plays the same role
    (ddpm_training_ddp.py:105-112). Defaults: this process's rank and the
    group's size.
    """
    pc = process_count if process_count is not None else _process_count()
    pi = process_index if process_index is not None else _process_index()
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range for count {pc}")
    n = (len(paths) // pc) * pc
    if n == 0:
        raise ValueError(f"{len(paths)} files cannot be partitioned across {pc} processes")
    return list(paths[pi:n:pc])


def assemble_global_batch(local_batch, mesh, data_axis: str = "data") -> torch.Tensor:
    """This process's (B_local, ...) rows of the global batch, on its device.

    The JAX function builds one global array from every host's rows; here
    each rank keeps its own rows (the global batch is their concatenation
    in rank order along `data_axis`). It checks that every rank of the data
    group holds the same local shape, as the global array requires.
    """
    local = torch.as_tensor(local_batch)
    if local.device != mesh.device:
        local = local.to(mesh.device, non_blocking=True)
    group = mesh.group(data_axis)
    if group is not None:
        shape = torch.tensor(list(local.shape), dtype=torch.int64, device=mesh.device)
        shapes = [torch.empty_like(shape) for _ in range(mesh.shape[data_axis])]
        dist.all_gather(shapes, shape, group=group)
        if any(not torch.equal(s, shape) for s in shapes):
            raise ValueError(
                f"local batch shapes differ across ranks: {[tuple(s.tolist()) for s in shapes]}"
            )
    return local


def global_batches(
    local_iter: Iterable,
    mesh,
    data_axis: str = "data",
    prefetch: int = 2,
) -> Iterator:
    """A per-process local-batch iterator as rows of the global batch on this
    rank's device, `prefetch` batches in flight (the multi-process
    counterpart of `data.prefetch_to_device`). Tuples keep their structure."""
    from ..data.pipeline import prefetch_to_device

    def checked(batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(checked(b) for b in batch)
        return assemble_global_batch(batch, mesh, data_axis)

    # the shape check is a collective: it runs on the consumer's thread, in
    # step order on every rank
    for batch in prefetch_to_device(iter(local_iter), size=prefetch, device=mesh.device):
        yield checked(batch)
