"""Two-stage 3D latent diffusion training recipe.

Counterpart of generativemodels_tpu/recipes/train_3d_ldm.py: stage 1 trains
a 3D AutoencoderKL adversarially (PatchGAN, L1 + KL, reconstruction-only
warm-up steps), the LDM scale factor is 1/std(z) of a batch's latents, and
stage 2 trains a 3D diffusion UNet on the latent through
`LatentDiffusionInferer`; `--sample` then samples one volume through the
latent route (the DDPM scheduler over `--sample-steps`, as the JAX recipe).
With `--stage2-steps 0` it is the 3d_autoencoderkl tutorial without its
perceptual term. Model widths are the JAX recipe's (AEKL (32, 64, 64) with
attention on its last level and 3 latent channels, PatchGAN 32 channels,
3 layers, instance norm, latent UNet (32, 64, 64) with heads of 64);
`--dtype bf16` computes both networks in bf16 over float32 parameters.

On `--device` (default cuda), with `train_2d_ldm`'s steps and draws. At a
128^3 volume the AEKL's attention level is 32^3 = 32768 tokens with one
head of 64, and the UNet's level 1 is 16^3 = 4096 tokens: on CUDA both run
the hand-written flash attention kernels, forward and backward (the fused
backward under GMTPU_FLASH_FUSED_BWD=1).

`--data-dir` streams .nii/.nii.gz/.npy volumes through
`data.device_batches` (with `--fit`, `--cache` and `--augment`) in place
of the synthetic ones.

Usage:
    python -m generativemodels_tpu_torch.recipes.train_3d_ldm --stage1-steps 50 --stage2-steps 50
    python -m generativemodels_tpu_torch.recipes.train_3d_ldm --size 128 --sample
"""
from __future__ import annotations

import argparse
import time

import torch

from ..inferers import LatentDiffusionInferer
from ..networks.nets import AutoencoderKL, DiffusionModelUNet, PatchDiscriminator
from ..networks.schedulers import DDPMScheduler
from .data_flags import add_data_arguments, data_batches
from .serve import require_device
from .train_2d_ldm import train_ldm
from .train_3d_ddpm import synthetic_volume


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage1-steps", type=int, default=50)
    parser.add_argument("--stage2-steps", type=int, default=50,
                        help="0 = stage 1 only (the 3d_autoencoderkl tutorial)")
    parser.add_argument("--warmup-steps", type=int, default=10,
                        help="reconstruction-only steps before the adversarial term")
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--size", type=int, default=32,
                        help="cubic volume edge (latent is size/4)")
    parser.add_argument("--kl-weight", type=float, default=1e-6)
    parser.add_argument("--adv-weight", type=float, default=0.01)
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="f32")
    parser.add_argument("--sample", action="store_true",
                        help="sample one volume through the latent route at the end")
    parser.add_argument("--sample-steps", type=int, default=50)
    add_data_arguments(parser)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def build_models(
    dtype: torch.dtype | None = None, use_flash_attention: bool | None = None
) -> tuple[AutoencoderKL, PatchDiscriminator, DiffusionModelUNet]:
    """The recipe's AutoencoderKL, PatchDiscriminator and latent UNet
    (reference 3d_ldm_tutorial.py:141-153 and :298-310)."""
    aekl = AutoencoderKL(
        spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=(32, 64, 64), attention_levels=(False, False, True),
        latent_channels=3, norm_num_groups=16,
        with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
        use_flash_attention=use_flash_attention, dtype=dtype,
    )
    disc = PatchDiscriminator(spatial_dims=3, num_channels=32, in_channels=1, num_layers_d=3,
                              norm="INSTANCE")
    unet = DiffusionModelUNet(
        spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=1,
        num_channels=(32, 64, 64), attention_levels=(False, True, True),
        num_head_channels=64, norm_num_groups=16, use_flash_attention=use_flash_attention,
        dtype=dtype,
    )
    return aekl, disc, unet


def main(argv: list[str] | None = None) -> dict:
    """Train both stages; returns `train_2d_ldm.train_ldm`'s dict with
    "sample" (the decoded volume with --sample, else None)."""
    args = build_argparser().parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        aekl, disc, unet = (m.to(device).train() for m in build_models(dtype))

    data_iter = data_batches(args, 3, device)

    def next_batch(generator):
        if data_iter is not None:
            return next(data_iter)
        return synthetic_volume(generator, args.batch, args.size, device)

    # reference 3d_ldm_tutorial.py:178-179: both optimizers at 1e-4
    result = train_ldm(args, device, aekl, disc, unet, (1e-4, 1e-4), next_batch)
    result["sample"] = None
    if args.sample and args.stage2_steps > 0:
        unet.eval()
        scheduler = DDPMScheduler(num_train_timesteps=1000, device=device)
        scheduler.set_timesteps(args.sample_steps)
        sampler = LatentDiffusionInferer(scheduler, scale_factor=result["scale_factor"])
        g = torch.Generator(device).manual_seed(7)
        latent = args.size // 4
        t0 = time.perf_counter()
        with torch.inference_mode():
            noise = torch.randn((1, 3, latent, latent, latent), generator=g, device=device)
            img = sampler.sample(noise, aekl, lambda x, t, context=None: unet(x, t), generator=g)
        print(f"latent sample decoded to {tuple(img.shape)} in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"range [{float(img.min()):.3f}, {float(img.max()):.3f}]")
        result["sample"] = img
    print("done")
    return result


if __name__ == "__main__":
    main()
