"""Time two of chip_smoke.py's recipe-level measurements on one checkout of
the port, so that two checkouts can be compared on one card in one call:

- `stage1`: the f32 3D LDM stage-1 G+D step of `recipes/train_3d_ldm.py`
  at 128^3, batch 2, split backward (chip_smoke.py's phase 10 (a)): the
  recipe's own seconds a step (host clock ending in a synchronize) over the
  steps after the warm-up ones;
- `export2d`: `recipes.serve.export_sampler` on the 2D serving sampler at
  its serving config (chip_smoke.py's SERVE: 64x64, UNet (128, 256, 256),
  batch 4, DDIM-50; phase 14 (b) exports it with the chain cut to
  DDIM-10): seconds to trace and save the .pt2 file, a host cost.

    python generativemodels_tpu_torch/probes/recipe_times.py [--root DIR]
        [--what stage1 export2d] [--out FILE]

`--root` is the root of the checkout whose `generativemodels_tpu_torch` is
imported (default: the checkout holding this file); its kernels are built
from its own sources. Run it on two checkouts in turns (A, B, B, A) and
compare within the call. Prints one JSON object per measurement with the
card's name and power limit and, with `--out`, appends them to FILE. Needs
a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGE1_WARMUP, STAGE1_STEPS = 2, 8  # chip_smoke.py's LDM3D_STEPS
# chip_smoke.py's SERVE, the chain whole
SERVE = dict(spatial_dims=2, size=64, channels=(128, 256, 256), norm_groups=32, batch=4,
             ddim_steps=50)


def stage1(torch) -> dict:
    from generativemodels_tpu_torch.recipes import train_3d_ldm

    out = train_3d_ldm.main(["--size", "128", "--batch", "2", "--dtype", "f32",
                             "--warmup-steps", str(STAGE1_WARMUP),
                             "--stage1-steps", str(STAGE1_STEPS), "--stage2-steps", "0",
                             "--device", "cuda"])
    steps = out["stage1_seconds"][STAGE1_WARMUP:]
    return dict(seconds=sum(steps) / len(steps), steps=steps)


def export2d(torch) -> dict:
    from generativemodels_tpu_torch.recipes import serve

    sampler, _ = serve.build_sampler(device="cuda", **SERVE)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        serve.export_sampler(sampler, os.path.join(root, "sampler_2d.pt2"))
        return dict(seconds=time.perf_counter() - t0)


MEASURES = {"stage1": stage1, "export2d": export2d}


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE_ROOT, help="checkout root to import the port from")
    parser.add_argument("--what", nargs="*", default=list(MEASURES), choices=list(MEASURES))
    parser.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("generativemodels_tpu_torch")]:
        del sys.modules[name]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("recipe_times needs a CUDA device")
    import generativemodels_tpu_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    root = os.path.dirname(os.path.dirname(os.path.abspath(generativemodels_tpu_torch.__file__)))
    results = []
    for what in args.what:
        line = dict(root=root, what=what, **MEASURES[what](torch), card=card)
        print(json.dumps(line), flush=True)
        results.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in results)
    return results


if __name__ == "__main__":
    main()
