"""Compare DDPM / DDIM / PNDM / DPM-Solver++ sampling from one trained model.

Counterpart of generativemodels_tpu/recipes/compare_schedulers.py (the
reference's 2d_ddpm_compare_schedulers tutorial): train one 2D DDPM, then
sample the same weights with each scheduler at several step counts and
report each one's agreement (MS-SSIM) with the DDPM-1000 reference
trajectory and its seconds. Every sampler starts from the same noise and a
generator seeded 11. A sample's seconds are the host clock around one
chain, synchronised on CUDA (the JAX recipe times a second, compiled run).

Usage:
    python -m generativemodels_tpu_torch.recipes.compare_schedulers --train-steps 200
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..inferers import DiffusionInferer
from ..metrics import MultiScaleSSIMMetric
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverMultistepScheduler,
    PNDMScheduler,
)
from ..parallel import init_train_state, make_diffusion_train_step
from .eval_quality import ms_ssim_weights_for
from .serve import require_device
from .train_2d_ddpm import synthetic_batch

SCHEDULERS = (
    ("DDPM", DDPMScheduler, {}),
    ("DDIM", DDIMScheduler, {}),
    ("PNDM", PNDMScheduler, {"skip_prk_steps": True}),
    ("DPM-Solver++", DPMSolverMultistepScheduler, {}),
)


def sample_with(scheduler_cls, kwargs, steps: int, fn, noise: torch.Tensor,
                seed: int = 11) -> tuple[torch.Tensor, float]:
    """(sample, seconds) of one `steps`-step chain of `scheduler_cls` from
    `noise`, its draws from a generator seeded `seed`."""
    scheduler = scheduler_cls(num_train_timesteps=1000, device=noise.device, **kwargs)
    scheduler.set_timesteps(steps)
    generator = torch.Generator(noise.device).manual_seed(seed)
    if noise.is_cuda:
        torch.cuda.synchronize(noise.device)
    t0 = time.time()
    with torch.inference_mode():
        img = DiffusionInferer(scheduler).sample(noise, fn, generator=generator)
    if noise.is_cuda:
        torch.cuda.synchronize(noise.device)
    return img, time.time() - t0


def main(argv: list[str] | None = None) -> list[dict]:
    """Train, sample, compare; returns the records written to `--out`."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--train-steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--sample-batch", type=int, default=8)
    parser.add_argument("--step-counts", type=int, nargs="+", default=[25, 50, 100])
    parser.add_argument("--channels", type=int, nargs="+", default=[64, 128, 128])
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--out", type=str, default="scheduler_comparison.json")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = require_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=tuple(args.channels),
            attention_levels=(False,) + (True,) * (len(args.channels) - 1),
            num_head_channels=args.channels[-1], norm_num_groups=args.norm_groups,
        )
    model = model.to(device).train()
    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000, device=device))
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=2.5e-5))
    generator = torch.Generator(device).manual_seed(42)
    loss = torch.zeros(())
    for _ in range(args.train_steps):
        images = synthetic_batch(generator, args.batch, args.size, device) * 2 - 1
        state, loss = step(state, images, generator)
    print(f"trained {args.train_steps} steps, final loss {float(loss):.4f}")

    model.eval()

    def fn(x, t, context=None):
        return model(x, t)

    noise = torch.randn((args.sample_batch, 1, args.size, args.size),
                        generator=torch.Generator(device).manual_seed(7), device=device)
    reference, ref_s = sample_with(DDPMScheduler, {}, 1000, fn, noise)
    ms_ssim = MultiScaleSSIMMetric(spatial_dims=2, data_range=2.0,
                                   weights=ms_ssim_weights_for(args.size))
    results = [{"scheduler": "DDPM", "steps": 1000, "seconds": round(ref_s, 3),
                "ms_ssim_vs_ref": 1.0}]
    for steps in args.step_counts:
        for name, cls, kwargs in SCHEDULERS:
            img, secs = sample_with(cls, kwargs, steps, fn, noise)
            agreement = float(torch.mean(ms_ssim(img, reference)))
            rec = {"scheduler": name, "steps": steps, "seconds": round(secs, 3),
                   "ms_ssim_vs_ref": round(agreement, 4)}
            results.append(rec)
            print(json.dumps(rec))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
