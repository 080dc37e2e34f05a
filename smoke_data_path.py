#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py alone, on one NVIDIA GPU: the host data path.

Builds the flash-attention kernels (flash_fwd.cu, flash_bwd.cu), runs phase
4 (a) (the 2D recipe on synthetic blobs, whose steps/s phase 13 (b) prints
beside its own), then phase 13: the loader, the 2D recipe trained from
disk with a checkpoint, that checkpoint served, `eval_quality` and
`eval_brain_ldm`. About two minutes with the build.

With --compare-prefetch it then runs phase 13 (b)'s training from disk again,
PREFETCH_STEPS steps a run, once for each design in PREFETCH_ORDER:
`data.prefetch_to_device` (a producer thread that prepares batches on the
host and queues their copies) and `deque_prefetch` below (the JAX
package's design: a deque of copies refilled by the consumer between
steps). It prints each run's steps/s and the device's busy share.

Run from the root of a checkout:

    python3 smoke_data_path.py [--compare-prefetch]
"""
from __future__ import annotations

import argparse
import collections
import os
import shutil
import sys
import tempfile
import time

import chip_smoke as smoke

PREFETCH_STEPS = 40
PREFETCH_ORDER = ("thread", "deque", "deque", "thread")


def deque_prefetch(iterator, size: int = 2, device="cuda"):
    """`prefetch_to_device` as the JAX package builds it
    (`generativemodels_tpu/data/pipeline.py:436-456`): `size` copies queued
    ahead, the next batch prepared on the host when the consumer asks."""
    import torch

    from generativemodels_tpu_torch.data import pipeline

    device = torch.device(device)
    queue = collections.deque()

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(iterator)
            except StopIteration:
                return
            queue.append(pipeline._to_device(batch, device))

    iterator = iter(iterator)
    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)


def compare_prefetch(torch, ops, recipe) -> dict:
    """Phase 13 (b)'s run from disk with each design of PREFETCH_ORDER, kernels
    1-3 counted; {design: [(steps/s, busy share, wall s), ...]}."""
    from generativemodels_tpu_torch.data import native, pipeline

    designs = {"thread": pipeline.prefetch_to_device, "deque": deque_prefetch}
    root = tempfile.mkdtemp(prefix="smoke_data_path_")
    results = {name: [] for name in designs}
    try:
        image_dir = smoke.write_slices(native, root)
        argv = ["--steps", str(PREFETCH_STEPS), *smoke.DISK_ARGS[2:], "--data-dir", image_dir,
                "--device", smoke.DEVICE]
        recipe.main([*argv[:1], "3", *argv[2:]])  # builds the loader; cuDNN's first plans
        for name in PREFETCH_ORDER:
            pipeline.prefetch_to_device = designs[name]
            try:
                torch.cuda.empty_cache()
                smoke.reset_launches(ops)
                out, wall, busy = smoke.profiled_run(torch, lambda: recipe.main(argv))
            finally:
                pipeline.prefetch_to_device = designs["thread"]
            smoke.check_launches(smoke.read_launches(ops), smoke.expected_launches(
                PREFETCH_STEPS, flash_fwd=3, flash_bwd_dq=3, flash_bwd_dkv=3), f"{name} run")
            results[name].append((out["steps_per_sec"], busy, wall))
            smoke.log(f"prefetch {name}: {out['steps_per_sec']:.3f} steps/s over steps "
                      f"3-{PREFETCH_STEPS}, busy share {busy:.3f} of {wall:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, runs in results.items():
        smoke.log(f"prefetch {name}: mean {sum(r[0] for r in runs) / len(runs):.3f} steps/s, "
                  f"busy {sum(r[1] for r in runs) / len(runs):.3f}")
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare-prefetch", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("smoke_data_path: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, smoke.REPO)
    from generativemodels_tpu_torch import inferers, ops
    from generativemodels_tpu_torch.data import native
    from generativemodels_tpu_torch.networks import schedulers
    from generativemodels_tpu_torch.ops.native import build_library
    from generativemodels_tpu_torch.recipes import serve
    from generativemodels_tpu_torch.recipes import train_2d_ddpm as recipe

    t0 = time.perf_counter()
    smoke.log(smoke.card_line())
    smoke.log(smoke.host_line(native))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["GMTPU_FUSED_RESBLOCK"] = "0"
    smoke.build_kernels(build_library, ("flash_fwd.cu", "flash_bwd.cu"))
    trained = smoke.train_recipe(torch, ops, recipe)
    t_data = time.perf_counter()
    smoke.run_data_path(torch, ops, recipe, serve, inferers, schedulers, trained["steps_per_sec"])
    smoke.log(f"data: phase 13 in {time.perf_counter() - t_data:.1f} s")
    if args.compare_prefetch:
        compare_prefetch(torch, ops, recipe)
    smoke.log(f"smoke_data_path: {time.perf_counter() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
