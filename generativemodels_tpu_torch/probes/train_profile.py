"""Profile one 2D training step on the card: device time by kernel group and
the device's busy share, at the 2D recipe's default (f32, batch 64) and at
bench.py's 2D config (bf16 compute, batch 128).

    python -m generativemodels_tpu_torch.probes.train_profile [--out FILE]

Each config builds the UNet of recipes/train_2d_ddpm.py (channels (128, 256,
256), one res block a level, one 256-wide head on levels 1-2, 64x64) from
seed 0, runs two warm-up steps of `make_diffusion_train_step` with Adam (lr
2.5e-5), then one step under torch.profiler (CUDA activity) with the host
clock around it, ending in a synchronize. TF32 is off, as in the recipe.
Prints one JSON line a config: device and wall ms, busy share, ms by group
and the largest kernels, with the card's name and power limit; `--out`
appends the lines to FILE. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDPMScheduler
from ..parallel import init_train_state, make_diffusion_train_step

# (name, UNet compute dtype, batch)
CONFIGS = (("recipe_f32", None, 64), ("bench_bf16", torch.bfloat16, 128))
CHANNELS = (128, 256, 256)
SIZE = 64
# kernel groups, matched in this order by name; cuDNN runs some f32
# convolutions as FFTs (`regular_fft_pad`, `vector_fft`,
# `pointwise_mult_and_sum_complex`)
GROUPS = (
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


def profile_step(name: str, dtype, batch: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=CHANNELS, attention_levels=(False, True, True),
            num_head_channels=CHANNELS[-1], dtype=dtype,
        )
    model = model.to("cuda").train()
    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000, device="cuda"))
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=2.5e-5))
    g = torch.Generator("cuda").manual_seed(2)
    images = torch.rand((batch, 1, SIZE, SIZE), generator=g, device="cuda") * 2 - 1
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
        config=name, batch=batch, dtype="bfloat16" if dtype else "float32",
        device_ms=total / 1e3, wall_ms=wall * 1e3, busy_share=total / 1e6 / wall,
        groups_ms=groups,
        top=[dict(kernel=e.key[:120], ms=e.device_time_total / 1e3, count=e.count) for e in top],
    )


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_profile needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = []
    for name, dtype, batch in CONFIGS:
        line = dict(profile_step(name, dtype, batch), card=card)
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
