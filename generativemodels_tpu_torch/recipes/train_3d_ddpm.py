"""Runnable 3D DDPM training recipe (BraTS-tutorial equivalent).

Counterpart of generativemodels_tpu/recipes/train_3d_ddpm.py: the same
model (3D `DiffusionModelUNet`, attention on the last level only,
`--head-channels` wide heads), DDPM scheduler, Adam, and synthetic blob
volumes or `--data-dir` volumes (`data.device_batches`, with `--fit`,
`--cache` and `--augment`), on `--device` (default cuda). `--dtype bf16` computes in bf16 with
float32 parameters; block recomputation in the backward is on unless
`--no-remat`, or set per level with `--remat-levels` (the UNet's
`use_checkpointing` tuple). Random draws come from `torch.Generator`s in
place of JAX keys: the model is initialised from seed 0, the volumes and
the step's noise from one generator seeded 42 on the device, the sample's
noise from one seeded 7. At 128^3 the attention level runs at 32^3 = 32768
tokens, through the hand-written flash attention kernels on CUDA, forward
and backward (the fused backward under GMTPU_FLASH_FUSED_BWD=1).

Usage:
    python -m generativemodels_tpu_torch.recipes.train_3d_ddpm --steps 100
    python -m generativemodels_tpu_torch.recipes.train_3d_ddpm \\
        --size 128 --batch 1 --channels 32 64 128 --no-remat --lr 2.5e-5

`--checkpoint-dir` saves {"params" (the EMA weights when tracked), "step"}
at the end.

`--data-parallel` / `--multihost` train as one rank of a torchrun process
group (recipes/data_flags.py): `--batch` is the global batch, every rank
draws the global batch's images and noise alike and keeps its rows, only
rank 0 prints and saves, and `--sample` is left to the saved checkpoint.
"""
from __future__ import annotations

import argparse
import copy
import time

import torch

from ..inferers import DiffusionInferer
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDIMScheduler, DDPMScheduler
from ..parallel import init_train_state, make_diffusion_train_step, shard_params
from ..utils import StepTimer
from .data_flags import (
    add_data_arguments,
    add_parallel_arguments,
    data_batches,
    global_rows,
    launch,
)
from .train_2d_ddpm import save_final


def synthetic_volume(
    generator: torch.Generator, batch: int, size: int, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """Random 3D blob volumes in [0, 1], (batch, 1, size, size, size) (stand-in for BraTS)."""
    lin = torch.linspace(-1, 1, size, device=device)
    xyz = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    centers = 0.8 * torch.rand((batch, 1, 1, 1, 3), generator=generator, device=device) - 0.4
    radii = 0.3 + 0.4 * torch.rand((batch, 1, 1, 1), generator=generator, device=device)
    d = torch.linalg.vector_norm(xyz[None] - centers, dim=-1)
    return torch.clamp(1.0 - d / radii, 0, 1)[:, None]


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--size", type=int, default=64, help="cubic volume edge")
    parser.add_argument("--lr", type=float, default=5e-5,
                        help="reference 3d_ddpm_tutorial.py:188")
    parser.add_argument("--channels", type=int, nargs="+", default=[32, 64, 128],
                        help="per-level channels; the reference tutorial uses "
                        "256 256 512 on downsampled volumes")
    parser.add_argument("--num-res-blocks", type=int, default=1)
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--head-channels", type=int, default=64)
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    parser.add_argument("--no-remat", action="store_true",
                        help="disable block recomputation (needs more memory)")
    parser.add_argument("--remat-levels", type=int, nargs="+", default=None, metavar="0|1",
                        help="per-level recomputation flags, one per --channels entry")
    parser.add_argument("--prediction-type", choices=["epsilon", "v_prediction"],
                        default="epsilon")
    parser.add_argument("--accumulate", type=int, default=1,
                        help="gradient-accumulation microbatches per optimizer "
                        "update (batch must divide evenly)")
    parser.add_argument("--ema-decay", type=float, default=None,
                        help="maintain an EMA of the params (e.g. 0.9999); "
                        "sampling and the saved checkpoint then use the EMA weights")
    add_data_arguments(parser)
    add_parallel_arguments(parser)
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="save {params, step} there after training")
    parser.add_argument("--sample", action="store_true", help="sample after training")
    parser.add_argument("--sample-steps", type=int, default=50,
                        help="DDIM steps for the post-training sample")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"state", "losses" (one float a step), "steps_per_sec",
    "sample" (the DDIM sample with --sample, else None)}."""
    args = build_argparser().parse_args(argv)
    run = launch(args)
    device = run.device
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if args.remat_levels is not None:
        remat = tuple(bool(r) for r in args.remat_levels)
    else:
        remat = not args.no_remat
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=3, in_channels=1, out_channels=1,
            num_res_blocks=args.num_res_blocks,
            num_channels=tuple(args.channels),
            attention_levels=(False,) * (len(args.channels) - 1) + (True,),
            num_head_channels=args.head_channels,
            norm_num_groups=args.norm_groups,
            dtype=torch.bfloat16 if args.dtype == "bf16" else None,
            use_checkpointing=remat,
        )
    model = model.to(device).train()
    if run.mesh is not None:
        shard_params(model, run.mesh)
    scheduler = DDPMScheduler(
        num_train_timesteps=1000, prediction_type=args.prediction_type, device=device
    )
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    step = make_diffusion_train_step(
        scheduler, mesh=run.mesh, prediction_target=args.prediction_type,
        accumulate_steps=args.accumulate, ema_decay=args.ema_decay,
    )
    state = init_train_state(model, optimizer, ema=args.ema_decay is not None)

    timer = StepTimer(warmup=2)
    generator = torch.Generator(device).manual_seed(42)
    data_iter = data_batches(args, 3, device, run.mesh)
    losses = []
    for i in range(args.steps):
        if data_iter is not None:
            images = next(data_iter) * 2 - 1
        else:
            images = global_rows(
                run, lambda n: synthetic_volume(generator, n, args.size, device), args.batch) * 2 - 1
        state, loss = step(state, images, generator)
        losses.append(loss)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # time the step, not its queueing
        timer.tick()
        if (i + 1) % 20 == 0 and run.is_main:
            sps = timer.steps_per_sec
            print(f"step {i + 1}/{args.steps} loss={float(loss):.4f}"
                  + (f" {sps:.2f} steps/s" if sps else ""))

    steps_per_sec = timer.steps_per_sec  # read now: it counts until it is read
    # EMA weights (when tracked) are what checkpoints and sampling consume
    if args.checkpoint_dir and run.is_main:
        final_params = (state.ema_params if args.ema_decay is not None
                        else state.model.state_dict())
        save_final(args.checkpoint_dir, final_params, state.step)
        print(f"checkpoint saved at step {state.step}"
              + (" (EMA weights)" if args.ema_decay is not None else ""))

    img = None
    if args.sample and run.count > 1:
        if run.is_main:
            print("--sample is a single-process path; sample from the saved "
                  "checkpoint instead (recipes/serve.py)")
    elif args.sample:
        sampler = state.model
        if args.ema_decay is not None:
            sampler = copy.deepcopy(state.model)
            sampler.load_state_dict(state.ema_params)
        sampler.eval()
        ddim = DDIMScheduler(num_train_timesteps=1000, device=device)
        ddim.set_timesteps(args.sample_steps)
        g = torch.Generator(device).manual_seed(7)
        t0 = time.time()
        with torch.inference_mode():
            noise = torch.randn((1, 1) + (args.size,) * 3, generator=g, device=device)
            img = DiffusionInferer(ddim).sample(
                noise, lambda x, t, context=None: sampler(x, t), generator=g
            )
        print(f"DDIM-{args.sample_steps} sample in {time.time() - t0:.1f}s, "
              f"range [{float(img.min()):.3f}, {float(img.max()):.3f}]")
    run.close()

    return dict(
        state=state,
        losses=[float(x) for x in losses],
        steps_per_sec=steps_per_sec,
        sample=img,
    )


if __name__ == "__main__":
    main()
