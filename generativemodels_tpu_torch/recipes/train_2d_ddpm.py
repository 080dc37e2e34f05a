"""Runnable 2D DDPM training recipe (MedNIST-tutorial equivalent).

Counterpart of generativemodels_tpu/recipes/train_2d_ddpm.py: the same
model (2D `DiffusionModelUNet`, one res block a level, attention on every
level but the first, one head as wide as the last level), DDPM scheduler,
Adam, and synthetic blob images or `--data-dir` files (`data.device_batches`:
fitted by `--fit`, optionally `--cache`d in RAM and `--augment`ed), on
`--device` (default cuda). Random draws come from `torch.Generator`s in
place of JAX keys: the model is initialised from seed 0, the synthetic data
and the step's noise from one generator seeded 42 on the device. The long
self-attention levels go through the hand-written flash attention kernels,
forward and backward, on CUDA. `--checkpoint-dir` saves {"params" (the
state dict; the EMA weights when tracked), "step"} at the end, which
`recipes.serve --checkpoint-dir` serves.

Usage:
    python -m generativemodels_tpu_torch.recipes.train_2d_ddpm --steps 100
    python -m generativemodels_tpu_torch.recipes.train_2d_ddpm --data-dir DIR \\
        --fit crop_pad --augment --cache --checkpoint-dir CKPT

Not ported yet: `--data-parallel/--multihost`.
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
from ..utils import CheckpointManager, StepTimer
from .data_flags import add_data_arguments, data_batches
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


def save_final(directory: str, params: dict[str, torch.Tensor], step: int) -> None:
    """Save {"params", "step"} at `step`, as the JAX recipes save their final
    params (a directory that already holds a later step keeps it)."""
    mgr = CheckpointManager(directory)
    mgr.save(step, {"params": params, "step": step})
    mgr.close()


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
                        "sampling and the saved checkpoint then use the EMA weights")
    add_data_arguments(parser)
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="save {params, step} there after training")
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
    data_iter = data_batches(args, 2, device)
    losses = []
    for i in range(args.steps):
        if data_iter is not None:
            images = next(data_iter) * 2 - 1
        else:
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

    # EMA weights (when tracked) are what checkpoints and sampling consume
    final_params = state.ema_params if args.ema_decay is not None else state.model.state_dict()
    if args.checkpoint_dir:
        save_final(args.checkpoint_dir, final_params, state.step)
        print(f"checkpoint saved at step {state.step}"
              + (" (EMA weights)" if args.ema_decay is not None else ""))

    if args.sample:
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
