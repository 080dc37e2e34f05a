"""Image-to-image translation recipe: segmentation with DDPMs.

Counterpart of generativemodels_tpu/recipes/segmentation_ddpm.py (the
reference's tutorial_segmentation_with_ddpm): a DDPM over segmentation
masks whose every denoising step is conditioned by concatenating the
source image into the channels (in_channels=2). Sampling the reverse chain
repeatedly with the same image gives an ensemble whose spread is an
uncertainty map. The JAX vmap over the ensemble is a loop over its
members. At the defaults the UNet attends over 16x16 = 256 tokens, under
the flash kernels' threshold: the recipe launches no kernel.

Usage:
    python -m generativemodels_tpu_torch.recipes.segmentation_ddpm --steps 50
"""
from __future__ import annotations

import argparse
from typing import Iterable

import torch
from torch import nn

from ..inferers import DiffusionInferer
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDPMScheduler
from ..parallel import init_train_state
from .data_flags import add_data_arguments
from .draws import Draws
from .serve import require_device
from .train_controlnet import ControlNetTrainStep, synthetic_masked_batch


class SegmentationTrainStep(ControlNetTrainStep):
    """`step(state, images, masks, generator) -> (state, loss)`: the model
    denoises the masks conditioned on the images (concat); the noise is of
    the masks' shape, drawn before the timesteps."""

    def __init__(self, scheduler, num_train_timesteps: int | None = None) -> None:
        super().__init__(None, scheduler, num_train_timesteps)
        self.inferer = DiffusionInferer(scheduler)

    def loss_fn(self, model: nn.Module, images, masks, noise, timesteps) -> torch.Tensor:
        pred = self.inferer(masks, lambda x, t, context=None: model(x, t), noise, timesteps,
                            condition=images, mode="concat")
        return torch.mean((pred - noise) ** 2)

    @staticmethod
    def noised(images, masks) -> torch.Tensor:
        return masks


def make_segmentation_train_step(scheduler, num_train_timesteps: int | None = None):
    return SegmentationTrainStep(scheduler, num_train_timesteps)


def segment_with_uncertainty(
    images: torch.Tensor,
    model_fn,
    scheduler,
    generator: torch.Generator | None = None,
    ensemble: int = 5,
    noise: Iterable[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample `ensemble` segmentations of `images`; returns (mean, std), the
    std the population one, as `jnp.std`.

    `noise` gives the draws in their order, in place of `generator`'s: for
    each member its initial noise, then its step noises stacked (steps,
    *images.shape).
    """
    draws = Draws(images.device, generator, noise)
    inferer = DiffusionInferer(scheduler)
    steps = len(scheduler.timesteps)
    members = []
    for _ in range(ensemble):
        x = draws.normal(images.shape, images.dtype)
        step_noise = draws.normal((steps, *images.shape), images.dtype)
        members.append(inferer.sample(x, model_fn, conditioning=images, mode="concat",
                                      step_noise=step_noise))
    members = torch.stack(members)
    return members.mean(dim=0), members.std(dim=0, correction=0)


def build_model() -> DiffusionModelUNet:
    """The recipe's UNet (in_channels 2: the noisy mask and the image), seed 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return DiffusionModelUNet(
            spatial_dims=2, in_channels=2, out_channels=1, num_res_blocks=1,
            num_channels=(64, 64, 64), attention_levels=(False, False, True),
            num_head_channels=64, norm_num_groups=32,
        )


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"state", "losses", "mean", "std" (with --sample)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2.5e-5)
    parser.add_argument("--ensemble", type=int, default=5)
    parser.add_argument("--sample", action="store_true")
    add_data_arguments(parser, labels=True)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if bool(args.data_dir) != bool(args.label_dir):
        parser.error("--data-dir and --label-dir must be given together")

    device = require_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    generator = torch.Generator(device).manual_seed(42)
    batches = None
    if args.data_dir:
        from ..data import batched_pairs, paired_stream, prefetch_to_device

        shape = (args.batch, 1, args.size, args.size)
        batches = prefetch_to_device(
            ((images.reshape(shape), masks.reshape(shape)) for images, masks in batched_pairs(
                paired_stream(args.data_dir, args.label_dir, (args.size,) * 2, args.fit),
                args.batch)),
            device=device,
        )

    def next_masked():
        if batches is not None:
            images, masks = next(batches)
            return images.float(), (masks > 0).float()
        return synthetic_masked_batch(generator, args.batch, args.size, device)

    model = build_model().to(device).train()
    scheduler = DDPMScheduler(num_train_timesteps=1000, device=device)
    step = make_segmentation_train_step(scheduler)
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=args.lr))
    losses = []
    for i in range(args.steps):
        state, loss = step(state, *next_masked(), generator)
        losses.append(loss)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1} loss={float(loss):.4f}")

    out = dict(state=state, losses=[float(x) for x in losses])
    if args.sample:
        images, _ = synthetic_masked_batch(generator, 2, args.size, device)
        model.eval()
        with torch.inference_mode():
            mean, std = segment_with_uncertainty(
                images, lambda x, t, context=None: model(x, t), scheduler, generator,
                ensemble=args.ensemble)
        print(f"segmentation: mean shape={tuple(mean.shape)} "
              f"uncertainty mean={float(std.mean()):.4f}")
        out.update(mean=mean, std=std)
    print("done")
    return out


if __name__ == "__main__":
    main()
