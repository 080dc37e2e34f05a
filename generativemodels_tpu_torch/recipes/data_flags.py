"""The training recipes' `--data-dir` flags and their batch stream, and the
diffusion recipes' launch flags `--data-parallel` / `--multihost`.

The JAX recipes each declare `--data-dir/--fit/--augment/--cache` (the
SPADE recipes `--data-dir/--label-dir/--fit`) and read through
`data.device_batches` (`data.paired_stream`); the port declares them here
once.

`--data-parallel` and `--multihost` run the recipe as one rank of a process
group (`parallel.initialize_multihost`), launched by torchrun:

    torchrun --nproc_per_node=8 -m generativemodels_tpu_torch.recipes.train_2d_ddpm \
        --data-parallel --batch 512

(across hosts: torchrun's `--nnodes/--node_rank/--master_addr`, or
`--multihost` with GMTPU_COORD/GMTPU_NPROC/GMTPU_RANK on every host).
`--batch` is then the global batch and must divide by the process count;
each rank keeps its rows of every global draw, reads its own file partition
with `--data-dir`, and only rank 0 prints and saves.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Iterator

import torch
import torch.distributed as dist

FITS = ("crop_pad", "resize", "none")


def add_data_arguments(parser: argparse.ArgumentParser, labels: bool = False) -> None:
    """`--data-dir` and `--fit`, then `--label-dir` (paired label maps) or
    `--augment` and `--cache`."""
    parser.add_argument("--data-dir", type=str, default=None,
                        help=".nii/.nii.gz/.npy/PNG/JPEG directory; synthetic blobs if omitted"
                        + ("; paired with --label-dir by sorted filename" if labels else ""))
    parser.add_argument("--fit", choices=FITS, default="crop_pad",
                        help="fit real-size samples to --size: centre crop/zero-pad, "
                        "interpolating resize, or none (shapes must already match)")
    if labels:
        parser.add_argument("--label-dir", type=str, default=None,
                            help="integer label-map directory (.npy/.nii/.png)")
        return
    parser.add_argument("--augment", action="store_true",
                        help="the tutorials' RandAffine augmentation (rotate +-5 degrees, "
                        "translate +-1 px, scale +-5%%, prob 0.5)")
    parser.add_argument("--cache", action="store_true",
                        help="decode and fit once, then serve the samples from host RAM")


def data_batches(args, spatial_dims: int, device: torch.device,
                 mesh=None) -> Iterator[torch.Tensor] | None:
    """(batch, 1, *size) float32 batches in [0, 1] on `device` from
    `args.data_dir`, or None without one. With a data mesh, this rank's
    rows of each global batch from its own file partition."""
    if not args.data_dir:
        return None
    from ..data import device_batches, multihost_device_batches

    if mesh is not None:
        return multihost_device_batches(args.data_dir, (args.size,) * spatial_dims, args.batch,
                                        mesh, args.fit, cache=args.cache, augment=args.augment)

    return device_batches(args.data_dir, (args.size,) * spatial_dims, args.batch, args.fit,
                          cache=args.cache, augment=args.augment, device=device)


def add_parallel_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--data-parallel", action="store_true",
                        help="one rank of a torchrun process group: the batch cut over the "
                        "ranks, gradients averaged (--batch is the global batch)")
    parser.add_argument("--multihost", action="store_true",
                        help="the same over several hosts: the coordinator from "
                        "GMTPU_COORD/GMTPU_NPROC/GMTPU_RANK or torchrun's variables")


@dataclass
class Launch:
    """Where this process trains: its device, the data mesh (None for a
    single-process run), its rank and the process count."""

    device: torch.device
    mesh: object = None
    rank: int = 0
    count: int = 1
    owns_group: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def close(self) -> None:
        """Leave the process group this launch started."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def launch(args) -> Launch:
    """The process group and the data mesh under `--data-parallel` or
    `--multihost`; else the plain `--device`."""
    from ..parallel import create_mesh, initialize_multihost, process_device
    from .serve import require_device

    if not (args.data_parallel or args.multihost):
        return Launch(require_device(args.device))
    owns = not dist.is_initialized()
    rank, count = initialize_multihost(device=args.device)
    if args.batch % count:
        # the JAX recipes floor it (train_2d_ddpm.py:145, train_3d_ddpm.py:191)
        raise ValueError(f"--batch {args.batch} does not divide over {count} processes")
    device = require_device(process_device(args.device))
    return Launch(device, create_mesh({"data": count}, device=device), rank, count, owns)


def global_rows(run: Launch, draw, batch: int):
    """This rank's rows of a global batch that every rank draws alike
    (`draw(batch)` from a generator seeded the same on every rank)."""
    images = draw(batch)
    if run.mesh is None:
        return images
    from ..parallel import shard_batch

    return shard_batch(images, run.mesh)
