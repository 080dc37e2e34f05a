"""Time the latent 128^3 route: a latent sample from noise to the decoded volume.

Counterpart of benchmarks/bench_3d_ldm.py (DDIM-50) and
benchmarks/bench_3d_ldm_dpm.py (DPM-Solver++(2M)-10) in one script, at
bench.py's fifth config (`measure_3d_ldm_samples_per_min`): AutoencoderKL
(32, 64, 64), one res block a level, no attention, 3 latent channels, bf16,
around a UNet (64, 128, 256) with two res blocks a level and 64-wide heads
on levels 1 and 2, bf16, at the 32^3 latent of a 128^3 volume, sampled
through `LatentDiffusionInferer` with scale factor 0.3:

    python -m generativemodels_tpu_torch.probes.bench_3d_ldm [--solver ddim|dpm]
        [--runs 3] [--device cuda] [--size 128] [--out FILE]

Both models take their initial weights from seeds (as the JAX scripts take
theirs from `init`; the UNet's zero-initialised output conv included). One
sample runs first as a warm-up (cuDNN's algorithm search among it), then
`--runs` samples, each timed on the host clock from the noise's draw to the
decoded volume, ending in a synchronize. Prints one JSON line (`--out`
appends it to FILE): seconds per sample, samples per minute, the warm-up's
seconds, the output's shape and the device, with the card's name and power
limit on CUDA. `--device` defaults to cuda and fails without a card;
`--device cpu` with a small `--size` rehearses the route on the host, whose
seconds say nothing of the card. GMTPU_FUSED_RESBLOCK=1 routes the UNet's
ResnetBlocks through kernel 5, as for the 3D UNet.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..inferers import DiffusionInferer, LatentDiffusionInferer
from ..networks.nets import AutoencoderKL, DiffusionModelUNet
from ..networks.schedulers import DDIMScheduler, DPMSolverMultistepScheduler

AEKL_CONFIG = dict(
    spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
    num_channels=(32, 64, 64), attention_levels=(False, False, False), latent_channels=3,
    norm_num_groups=32, with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
)
UNET_CONFIG = dict(
    spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=2,
    num_channels=(64, 128, 256), attention_levels=(False, True, True), num_head_channels=64,
    norm_num_groups=32,
)
SIZE = 128  # the volume's edge; the latent's is a quarter of it
SCALE_FACTOR = 0.3
SOLVER_STEPS = {"ddim": 50, "dpm": 10}


def build_models(device, dtype=torch.bfloat16, seed: int = 0):
    """(AutoencoderKL, DiffusionModelUNet) at bench.py's config, on
    `device`, in eval mode, initial weights from `seed` and `seed` + 1."""
    models = []
    for i, (cls, config) in enumerate(((AutoencoderKL, AEKL_CONFIG),
                                       (DiffusionModelUNet, UNET_CONFIG))):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + i)
            models.append(cls(**config, dtype=dtype).to(device).eval())
    return tuple(models)


def make_scheduler(solver: str, device):
    """bench.py's DDIM (1000 train steps) or the DPM-Solver++(2M) variant,
    with its plan of SOLVER_STEPS[solver] steps."""
    if solver == "ddim":
        scheduler = DDIMScheduler(num_train_timesteps=1000, device=device)
    elif solver == "dpm":
        scheduler = DPMSolverMultistepScheduler(num_train_timesteps=1000, device=device)
    else:
        raise ValueError(f"solver must be one of {sorted(SOLVER_STEPS)}, got {solver!r}")
    scheduler.set_timesteps(SOLVER_STEPS[solver])
    return scheduler


def latent_shape(size: int = SIZE) -> tuple[int, ...]:
    return (1, AEKL_CONFIG["latent_channels"]) + (size // 4,) * 3


def sample(inferer, aekl, unet, seed: int, size: int = SIZE, **kwargs):
    """One latent sample, from a noise drawn from `seed` to the decoded volume."""
    device = next(unet.parameters()).device
    g = torch.Generator(device).manual_seed(seed)
    with torch.inference_mode():
        noise = torch.randn(latent_shape(size), generator=g, device=device)
        return inferer.sample(noise, aekl, unet, generator=g, **kwargs)


def timed_sample(inferer, aekl, unet, seed: int, size: int = SIZE):
    """(volume, seconds on the host clock, ending in a synchronize on CUDA)."""
    cuda = next(unet.parameters()).is_cuda
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = sample(inferer, aekl, unet, seed, size)
    if cuda:
        torch.cuda.synchronize()
    return image, time.perf_counter() - t0


def split_ms(inferer, aekl, unet, seed: int, size: int = SIZE) -> tuple[float, float]:
    """(ms of the latent chain, ms of the decode) of one sample on the card,
    from CUDA events around each (the chain's host work among it)."""
    device = next(unet.parameters()).device
    if device.type != "cuda":
        raise ValueError("split_ms times the card: the models must lie on a CUDA device")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    g = torch.Generator(device).manual_seed(seed)
    with torch.inference_mode():
        noise = torch.randn(latent_shape(size), generator=g, device=device)
        events[0].record()
        latent = DiffusionInferer.sample(inferer, noise, unet, generator=g)
        events[1].record()
        inferer._decode(aekl, latent)
        events[2].record()
    torch.cuda.synchronize()
    return events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run(solver: str = "ddim", device="cuda", runs: int = 3, size: int = SIZE,
        models=None) -> dict:
    """Time `runs` samples after one warm-up; the result as `main` prints it.
    `models` (an (AutoencoderKL, UNet) pair on `device`) replaces the seeded
    ones."""
    device = torch.device(device)
    aekl, unet = models or build_models(device)
    scheduler = make_scheduler(solver, device)
    inferer = LatentDiffusionInferer(scheduler, scale_factor=SCALE_FACTOR)
    _, first = timed_sample(inferer, aekl, unet, seed=5, size=size)
    seconds = []
    for i in range(runs):
        image, s = timed_sample(inferer, aekl, unet, seed=6 + i, size=size)
        seconds.append(s)
    if not bool(torch.isfinite(image).all()):
        raise AssertionError("the decoded volume is not finite")
    per = sum(seconds) / len(seconds)
    n = len(scheduler.timesteps)
    name = "ddim" if solver == "ddim" else "dpmsolver"
    result = {
        "metric": f"3d_{size}_ldm_{name}{n}_samples_per_min",
        "value": 60.0 / per,
        "seconds_per_sample": per,
        "seconds": seconds,
        "first_s": first,
        "config": f"AEKL(32,64,64) 4x-down + UNet(64,128,256)@{size // 4}^3 latent, bf16, "
                  f"{'DDIM' if solver == 'ddim' else 'DPM-Solver++(2M)'}-{n}",
        "out_shape": list(image.shape),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    if device.type == "cuda":
        result["card"] = card_line()
    return result


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--solver", choices=sorted(SOLVER_STEPS), default="ddim")
    parser.add_argument("--runs", type=int, default=3, help="timed samples after the warm-up")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--size", type=int, default=SIZE,
                        help="the volume's edge, a multiple of 16 (default 128)")
    parser.add_argument("--out", default=None, help="append the JSON line to this file")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark times the card (--device cpu rehearses)")
    if args.size % 16:
        raise SystemExit(f"--size must be a multiple of 16, got {args.size}")
    result = run(args.solver, device, args.runs, args.size)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
