"""The training recipes' `--data-dir` flags and their batch stream.

The JAX recipes each declare `--data-dir/--fit/--augment/--cache` (the
SPADE recipes `--data-dir/--label-dir/--fit`) and read through
`data.device_batches` (`data.paired_stream`); the port declares them here
once.
"""
from __future__ import annotations

import argparse
from typing import Iterator

import torch

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


def data_batches(args, spatial_dims: int, device: torch.device) -> Iterator[torch.Tensor] | None:
    """(batch, 1, *size) float32 batches in [0, 1] on `device` from
    `args.data_dir`, or None without one."""
    if not args.data_dir:
        return None
    from ..data import device_batches

    return device_batches(args.data_dir, (args.size,) * spatial_dims, args.batch, args.fit,
                          cache=args.cache, augment=args.augment, device=device)
