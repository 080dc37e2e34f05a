"""Runnable 2D DDPM training recipe (MedNIST-tutorial equivalent).

Counterpart of generativemodels_tpu/recipes/train_2d_ddpm.py: the same
model (2D `DiffusionModelUNet`, one res block a level, attention on every
level but the first, one head as wide as the last level), DDPM scheduler,
Adam and synthetic blob images, on `--device` (default cuda). Random draws
come from `torch.Generator`s in place of JAX keys: the model is initialised
from seed 0, the data and the step's noise from one generator seeded 42 on
the device. The long self-attention levels go through the hand-written flash
attention kernels, forward and backward, on CUDA.

Usage: python -m generativemodels_tpu_torch.recipes.train_2d_ddpm --steps 100

Not ported yet: `--data-dir/--fit/--augment/--cache` (real data),
`--data-parallel/--multihost` and `--checkpoint-dir`.
"""
from __future__ import annotations

import argparse
import copy
import time

import torch

from ..inferers import DiffusionInferer
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDPMScheduler
from ..parallel import init_train_state, make_diffusion_train_step
from ..utils import StepTimer
from .serve import require_device


def synthetic_batch(
    generator: torch.Generator, batch: int, size: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Random blob images in [0, 1], (batch, 1, size, size) (stand-in for MedNIST)."""
    lin = torch.linspace(-1, 1, size, device=device)
    xy = torch.stack(torch.meshgrid(lin, lin, indexing="xy"), -1)
    centers = torch.rand((batch, 1, 1, 2), generator=generator, device=device) - 0.5
    radii = 0.2 + 0.4 * torch.rand((batch, 1, 1), generator=generator, device=device)
    d = torch.linalg.vector_norm(xy[None] - centers, dim=-1)
    return torch.clamp(1.0 - d / radii, 0, 1)[:, None, :, :]


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"state", "losses" (one float a step), "steps_per_sec"}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2.5e-5)
    parser.add_argument("--channels", type=int, nargs="+", default=[128, 256, 256])
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--prediction-type", choices=["epsilon", "v_prediction"],
                        default="epsilon",
                        help="training target; v_prediction mirrors "
                        "2d_ddpm_tutorial_v_prediction.py")
    parser.add_argument("--accumulate", type=int, default=1,
                        help="gradient-accumulation microbatches per optimizer "
                        "update (batch must divide evenly)")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="maintain an EMA of the params (e.g. 0.9999); "
                        "sampling then uses the EMA weights")
    parser.add_argument("--sample", action="store_true", help="sample after training")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=tuple(args.channels),
            attention_levels=(False,) + (True,) * (len(args.channels) - 1),
            num_head_channels=args.channels[-1],
            norm_num_groups=args.norm_groups,
        )
    model = model.to(device).train()
    scheduler = DDPMScheduler(
        num_train_timesteps=1000, prediction_type=args.prediction_type, device=device
    )
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = make_diffusion_train_step(
        scheduler, prediction_target=args.prediction_type,
        accumulate_steps=args.accumulate, ema_decay=args.ema_decay,
    )
    state = init_train_state(model, optimizer, ema=args.ema_decay is not None)

    timer = StepTimer(warmup=2)
    generator = torch.Generator(device).manual_seed(42)
    losses = []
    for i in range(args.steps):
        images = synthetic_batch(generator, args.batch, args.size, device) * 2 - 1
        state, loss = step(state, images, generator)
        losses.append(loss)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # time the step, not its queueing
        timer.tick()
        if (i + 1) % 20 == 0:
            sps = timer.steps_per_sec
            print(f"step {i + 1}/{args.steps} loss={float(loss):.4f}"
                  + (f" {sps:.2f} steps/s" if sps else ""))

    if args.sample:
        # EMA weights (when tracked) are what sampling consumes
        sampler = state.model
        if args.ema_decay is not None:
            sampler = copy.deepcopy(state.model)
            sampler.load_state_dict(state.ema_params)
        sampler.eval()
        scheduler.set_timesteps(1000)
        g = torch.Generator(device).manual_seed(7)
        t0 = time.time()
        with torch.inference_mode():
            noise = torch.randn((1, 1, args.size, args.size), generator=g, device=device)
            img = DiffusionInferer(scheduler).sample(
                noise, lambda x, t, context=None: sampler(x, t), generator=g
            )
        print(f"1000-step sample in {time.time() - t0:.1f}s, "
              f"range [{float(img.min()):.3f}, {float(img.max()):.3f}]")

    return dict(
        state=state,
        losses=[float(x) for x in losses],
        steps_per_sec=timer.steps_per_sec,
    )


if __name__ == "__main__":
    main()
