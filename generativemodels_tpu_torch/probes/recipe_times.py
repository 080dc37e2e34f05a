"""Time recipe-level measurements on one checkout of the port, so that two
checkouts can be compared on one card in one call:

- `stage1`: the f32 3D LDM stage-1 G+D step of `recipes/train_3d_ldm.py`
  at 128^3, batch 2, split backward, or fused with GMTPU_FLASH_FUSED_BWD=1
  in the environment (chip_smoke.py's phase 10 (a)): the recipe's own
  seconds a step (host clock ending in a synchronize) over the steps after
  the warm-up ones;
- `export2d`: `recipes.serve.export_sampler` on the 2D serving sampler at
  its serving config (chip_smoke.py's SERVE: 64x64, UNet (128, 256, 256),
  batch 4, DDIM-50; phase 14 (b) exports it with the chain cut to
  DDIM-10): seconds to trace and save the .pt2 file, a host cost;
- `controlnet`: the ControlNet step of `recipes/train_controlnet.py` at its
  defaults (UNet and ControlNet (64, 128, 128), 64x64, batch 16, f32, TF32
  off; kernels 1-3 at (16, 1024, 1024, 128)), the UNet frozen and the
  ControlNet seeded from it as the recipe does: each step's host clock
  ending in a synchronize and its CUDA-event time, over the steps after the
  warm-up ones, then one step under torch.profiler for its device time,
  busy share (device time over that step's wall time) and kernels 1-3's
  device time;
- `serve2d`: a DDIM-50 request of the 2D serving sampler at its serving
  config (chip_smoke.py's phase 3: 150 launches of kernel 1 at (4, 1024,
  1024, 256) and (4, 256, 256, 256) f32): each request's host clock ending
  in a synchronize over the requests after a warm-up one, then one request
  under torch.profiler for its device time, busy share and kernel 1's
  device time, and one with the host's activity too for the host time of
  the `gmtpu_torch::flash_fwd` op (its launcher, launch included).

    python generativemodels_tpu_torch/probes/recipe_times.py [--root DIR]
        [--what stage1 export2d controlnet serve2d] [--out FILE]

`--root` is the root of the checkout whose `generativemodels_tpu_torch` is
imported (default: the checkout holding this file); its kernels are built
from its own sources. Run it on two checkouts in turns (A, B, B, A) and
compare within the call. Prints one JSON object per measurement with the
card's name and power limit (and `fused_backward`: whether
GMTPU_FLASH_FUSED_BWD=1 was set) and, with `--out`, appends them to FILE.
Needs a card.
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
SERVE_REQUESTS = 3
CONTROLNET_WARMUP, CONTROLNET_STEPS = 2, 10
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


def controlnet(torch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from generativemodels_tpu_torch.networks.nets import copy_weights_to_controlnet
    from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
    from generativemodels_tpu_torch.parallel import init_train_state
    from generativemodels_tpu_torch.recipes import train_controlnet as tc

    torch.backends.cuda.matmul.allow_tf32 = False  # as the recipe sets them
    torch.backends.cudnn.allow_tf32 = False
    unet, cn = tc.build_models()
    unet, cn = unet.to("cuda").train(), cn.to("cuda").train()
    copy_weights_to_controlnet(cn, unet)
    step = tc.make_controlnet_train_step(unet, DDPMScheduler(num_train_timesteps=1000,
                                                             device="cuda"))
    state = init_train_state(cn, torch.optim.Adam(cn.parameters(), lr=2.5e-5))
    g = torch.Generator("cuda").manual_seed(42)
    images, masks = tc.synthetic_masked_batch(g, 16, 64, "cuda")
    for _ in range(CONTROLNET_WARMUP):
        state, _ = step(state, images, masks, g)
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(CONTROLNET_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, _ = step(state, images, masks, g)
        stop.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(stop))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, images, masks, g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    device = sum(e.device_time_total for e in kernels) / 1e3
    if device == 0:
        raise RuntimeError("the profiler saw no device time")
    flash = {name: sum(e.device_time_total for e in kernels if name + "_" in e.key) / 1e3
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return dict(seconds=sum(host) / len(host) / 1e3, host_ms=host, event_ms=events,
                profiled_device_ms=device, profiled_wall_ms=wall * 1e3,
                busy_share=device / (wall * 1e3), flash_ms=flash)


def serve2d(torch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from generativemodels_tpu_torch.recipes import serve

    sampler, _ = serve.build_sampler(device="cuda", **SERVE)
    sampler(0)  # warm-up
    torch.cuda.synchronize()
    host = []
    for seed in range(1, 1 + SERVE_REQUESTS):
        t0 = time.perf_counter()
        sampler(seed)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler(1 + SERVE_REQUESTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0]
    device = sum(e.device_time_total for e in kernels) / 1e3
    if device == 0:
        raise RuntimeError("the profiler saw no device time")
    flash = sum(e.device_time_total for e in kernels if "flash_fwd_" in e.key) / 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sampler(2 + SERVE_REQUESTS)
        torch.cuda.synchronize()
    op = [e for e in prof.key_averages() if e.key == "gmtpu_torch::flash_fwd"]
    return dict(seconds=sum(host) / len(host) / 1e3, host_ms=host, profiled_device_ms=device,
                profiled_wall_ms=wall * 1e3, busy_share=device / (wall * 1e3),
                flash_ms={"flash_fwd": flash},
                flash_fwd_host_ms=sum(e.cpu_time_total for e in op) / 1e3,
                flash_fwd_calls=sum(e.count for e in op))


MEASURES = {"stage1": stage1, "export2d": export2d, "controlnet": controlnet,
            "serve2d": serve2d}


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
        line = dict(root=root, what=what, **MEASURES[what](torch), card=card,
                    fused_backward=os.environ.get("GMTPU_FLASH_FUSED_BWD") == "1")
        print(json.dumps(line), flush=True)
        results.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in results)
    return results


if __name__ == "__main__":
    main()
