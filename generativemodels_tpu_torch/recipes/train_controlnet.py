"""2D ControlNet fine-tuning recipe (frozen diffusion model, trained ControlNet).

Counterpart of generativemodels_tpu/recipes/train_controlnet.py (the
reference's 2d_controlnet tutorial): (1) train a DDPM UNet, (2) create a
ControlNet, seed it from the UNet (`copy_weights_to_controlnet`, the
reference's non-strict load_state_dict), freeze the UNet and train only
the ControlNet on (image, mask) pairs, the mask a whole-image threshold of
the image. The UNet is frozen by `requires_grad_(False)`, and the optimizer
holds the ControlNet's parameters only; the loss still backpropagates
through the UNet's layers downstream of the ControlNet's residuals. On
CUDA the 1024-token attention levels of both networks run the flash
kernels, forward and backward. Random draws come from `torch.Generator`s:
the UNet is initialised from seed 0, the ControlNet from seed 1, the data
and the steps' noise from one generator seeded 42 on the device.

Usage:
    python -m generativemodels_tpu_torch.recipes.train_controlnet --steps 50
"""
from __future__ import annotations

import argparse

import torch
from torch import nn

from ..inferers import ControlNetDiffusionInferer
from ..networks.nets import ControlNet, DiffusionModelUNet, copy_weights_to_controlnet
from ..networks.schedulers import DDPMScheduler
from ..parallel import TrainState, init_train_state, make_diffusion_train_step
from .data_flags import add_data_arguments, data_batches
from .serve import require_device
from .train_2d_ddpm import synthetic_batch


def synthetic_masked_batch(generator: torch.Generator, batch: int, size: int,
                           device: torch.device | str = "cpu", threshold: float = 0.3):
    """(images, masks): blob images and their binary threshold masks (the
    tutorial's whole-brain mask)."""
    images = synthetic_batch(generator, batch, size, device)
    return images, (images > threshold).to(images.dtype)


class ControlNetTrainStep:
    """`step(state, images, masks, generator) -> (state, loss)`: one update of
    the ControlNet that `state` holds, with `frozen_unet` taking its
    residuals; `update(state, images, masks, noise, timesteps)` takes the
    draws as given (the noise of the images' shape, then the timesteps)."""

    def __init__(self, frozen_unet: nn.Module, scheduler,
                 num_train_timesteps: int | None = None) -> None:
        self.unet = frozen_unet
        self.scheduler = scheduler
        self.num_train_timesteps = num_train_timesteps or scheduler.num_train_timesteps

    def loss_fn(self, controlnet: nn.Module, images, masks, noise, timesteps) -> torch.Tensor:
        noisy = self.scheduler.add_noise(images, noise, timesteps)
        down_res, mid_res = controlnet(noisy, timesteps, controlnet_cond=masks)
        pred = self.unet(noisy, timesteps, down_block_additional_residuals=down_res,
                         mid_block_additional_residual=mid_res)
        return torch.mean((pred - noise) ** 2)

    def update(self, state: TrainState, images, masks, noise, timesteps):
        state.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(state.model, images, masks, noise, timesteps)
        loss.backward()
        state.optimizer.step()
        return TrainState(state.model, state.optimizer, state.step + 1, state.ema_params), \
            loss.detach()

    @staticmethod
    def noised(images, masks) -> torch.Tensor:
        """The tensor the step noises (its noise takes this one's shape)."""
        return images

    def __call__(self, state: TrainState, images, masks, generator: torch.Generator):
        like = self.noised(images, masks)
        noise = torch.randn(like.shape, generator=generator, device=like.device,
                            dtype=like.dtype)
        timesteps = torch.randint(0, self.num_train_timesteps, (like.shape[0],),
                                  generator=generator, device=like.device)
        return self.update(state, images, masks, noise, timesteps)


def make_controlnet_train_step(frozen_unet: nn.Module, scheduler,
                               num_train_timesteps: int | None = None) -> ControlNetTrainStep:
    """The ControlNet-only step; freezes `frozen_unet` (`requires_grad_(False)`).
    The state's optimizer must hold the ControlNet's parameters only."""
    frozen_unet.requires_grad_(False)
    return ControlNetTrainStep(frozen_unet, scheduler, num_train_timesteps)


def build_models(channels=(64, 128, 128), norm_groups: int = 32):
    """The recipe's UNet (seed 0) and ControlNet (seed 1), not yet seeded
    from each other."""
    unet_kwargs = dict(
        spatial_dims=2, in_channels=1, num_res_blocks=1, num_channels=tuple(channels),
        attention_levels=(False,) + (True,) * (len(channels) - 1),
        num_head_channels=channels[-1], norm_num_groups=norm_groups,
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = DiffusionModelUNet(out_channels=1, **unet_kwargs)
        torch.manual_seed(1)
        controlnet = ControlNet(conditioning_embedding_num_channels=(16,), **unet_kwargs)
    return unet, controlnet


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"unet", "state" (the ControlNet's), "losses" (the
    ControlNet phase's, one float a step), "samples" (with --sample)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--pretrain-steps", type=int, default=30)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2.5e-5)
    parser.add_argument("--channels", type=int, nargs="+", default=[64, 128, 128])
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--sample", action="store_true", help="sample after training")
    parser.add_argument("--mask-threshold", type=float, default=0.3)
    add_data_arguments(parser)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    generator = torch.Generator(device).manual_seed(42)
    data_iter = data_batches(args, 2, device)

    def next_batch():
        if data_iter is not None:
            return next(data_iter)
        return synthetic_batch(generator, args.batch, args.size, device)

    unet, controlnet = build_models(tuple(args.channels), args.norm_groups)
    unet, controlnet = unet.to(device).train(), controlnet.to(device).train()
    scheduler = DDPMScheduler(num_train_timesteps=1000, device=device)

    # phase 1: train the diffusion model
    pre_step = make_diffusion_train_step(scheduler)
    pre_state = init_train_state(unet, torch.optim.Adam(unet.parameters(), lr=args.lr))
    for i in range(args.pretrain_steps):
        pre_state, loss = pre_step(pre_state, next_batch(), generator)
        if (i + 1) % 10 == 0:
            print(f"[unet] step {i + 1} loss={float(loss):.4f}")

    # phase 2: the ControlNet seeded from the UNet, the UNet frozen
    copy_weights_to_controlnet(controlnet, unet)
    step = make_controlnet_train_step(unet, scheduler)
    state = init_train_state(controlnet, torch.optim.Adam(controlnet.parameters(), lr=args.lr))
    losses = []
    for i in range(args.steps):
        images = next_batch()
        state, loss = step(state, images, (images > args.mask_threshold).to(images.dtype),
                           generator)
        losses.append(loss)
        if (i + 1) % 10 == 0:
            print(f"[controlnet] step {i + 1} loss={float(loss):.4f}")

    samples = None
    if args.sample:
        _, masks = synthetic_masked_batch(generator, 4, args.size, device)
        noise = torch.randn((4, 1, args.size, args.size), generator=generator, device=device)
        unet.eval(), controlnet.eval()
        with torch.inference_mode():
            samples = ControlNetDiffusionInferer(scheduler).sample(
                noise, unet, controlnet, cn_cond=masks, generator=generator)
        print(f"samples: shape={tuple(samples.shape)} std={float(samples.std()):.3f}")
    print("done")
    return dict(unet=unet, state=state, losses=[float(x) for x in losses], samples=samples)


if __name__ == "__main__":
    main()
