"""Profile one training step on the card: device time by kernel group and
the device's busy share, at the 2D recipe's default (f32, batch 64), at
bench.py's 2D config (bf16 compute, batch 128) and at bench.py's 3D
training config (bf16, 128^3, batch 1).

    python generativemodels_tpu_torch/probes/train_profile.py [--root DIR]
        [--configs NAME ...] [--out FILE]

`--root` is the root of the checkout whose `generativemodels_tpu_torch` is
imported (default: the checkout holding this file), so that two checkouts
can be profiled on one card in one call; `--configs` keeps the configs
named. The 2D configs build the UNet of recipes/train_2d_ddpm.py (channels
(128, 256, 256), one res block a level, one 256-wide head on levels 1-2,
64x64); the 3D one bench.py's 3D UNet (channels (32, 64, 128), attention on
level 3 at 32^3 tokens in heads of 64: kernels 1-3 at (2, 32768, 32768, 64)
bf16). Each is built from seed 0, runs two warm-up steps of
`make_diffusion_train_step` with Adam (lr 2.5e-5), then one step under
torch.profiler (CUDA activity) with the host clock around it, ending in a
synchronize. TF32 is off, as in the recipe. The backward is the split one,
or the fused one (kernel 4) with GMTPU_FLASH_FUSED_BWD=1 in the
environment. Prints one JSON line a config: device and wall ms, busy
share, ms by group and the largest kernels, with the card's name and power
limit and `fused_backward`; `--out` appends the lines to FILE. Needs a
card. chip_smoke.py's phase 6 (c) profiles the 3D step through
`profile_step(torch, "bench3d_bf16")`, once with each backward.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# name: (spatial dims, channels, attention levels, head width, edge, UNet
# compute dtype name, batch)
CONFIGS = {
    "recipe_f32": (2, (128, 256, 256), (False, True, True), 256, 64, None, 64),
    "bench_bf16": (2, (128, 256, 256), (False, True, True), 256, 64, "bfloat16", 128),
    "bench3d_bf16": (3, (32, 64, 128), (False, False, True), 64, 128, "bfloat16", 1),
}
# kernel groups, matched in this order by name; cuDNN runs some f32
# convolutions as FFTs (`regular_fft_pad`, `vector_fft`,
# `pointwise_mult_and_sum_complex`)
GROUPS = (
    ("flash_bwd_fused (kernel 4)", ("flash_bwd_fused",)),
    ("flash_bwd_dq (kernel 2)", ("flash_bwd_dq",)),
    ("flash_bwd_dkv (kernel 3)", ("flash_bwd_dkv",)),
    ("flash_fwd (kernel 1)", ("flash_fwd",)),
    ("cuDNN convolutions and cuBLAS products", ("xmma", "cudnn", "conv", "gemm", "Conv",
                                                "cutlass", "fft", "complex")),
    ("GroupNorm forward and backward", ("Moments", "GroupNorm", "group_norm", "FusedParams",
                                        "InternalGradients")),
    ("copies, casts and fills", ("copy", "nchwToNhwc", "nhwcToNchw", "Memcpy", "Memset",
                                 "fill")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
    ("other", ("",)),
)


def profile_step(torch, name: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
    from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
    from generativemodels_tpu_torch.parallel import init_train_state, make_diffusion_train_step

    dims, channels, levels, head, edge, dtype_name, batch = CONFIGS[name]
    dtype = getattr(torch, dtype_name) if dtype_name else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=dims, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=channels, attention_levels=levels, num_head_channels=head,
            norm_num_groups=32, dtype=dtype,
        )
    model = model.to("cuda").train()
    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000, device="cuda"))
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=2.5e-5))
    g = torch.Generator("cuda").manual_seed(2)
    images = torch.rand((batch, 1) + (edge,) * dims, generator=g, device="cuda") * 2 - 1
    for _ in range(2):
        state, _ = step(state, images, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, images, g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    total = sum(e.device_time_total for e in events)
    if total == 0:
        raise RuntimeError("the profiler saw no device time")
    groups = dict.fromkeys((group for group, _ in GROUPS), 0.0)
    for e in events:
        group = next(label for label, keys in GROUPS if any(k in e.key for k in keys))
        groups[group] += e.device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:10]
    return dict(
        root=root_of(), config=name, batch=batch, dtype=dtype_name or "float32",
        device_ms=total / 1e3, wall_ms=wall * 1e3, busy_share=total / 1e6 / wall,
        kernels=sum(e.count for e in events),
        groups_ms=groups,
        top=[dict(kernel=e.key[:120], ms=e.device_time_total / 1e3, count=e.count) for e in top],
    )


def root_of() -> str:
    """The checkout whose port was imported."""
    import generativemodels_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(generativemodels_tpu_torch.__file__)))


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE_ROOT, help="checkout root to import the port from")
    parser.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=list(CONFIGS),
                        help="profile only these configs")
    parser.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("generativemodels_tpu_torch")]:
        del sys.modules[name]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = []
    for name in args.configs:
        line = dict(profile_step(torch, name), card=card,
                    fused_backward=os.environ.get("GMTPU_FLASH_FUSED_BWD") == "1")
        print(json.dumps(line), flush=True)
        results.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in results:
                f.write(json.dumps(line) + "\n")
    return results


if __name__ == "__main__":
    main()
