"""2D SPADE latent-diffusion training recipe (segmentation-conditioned LDM).

Counterpart of generativemodels_tpu/recipes/train_spade_ldm.py: stage 1
trains a SPADEAutoencoderKL adversarially (L1 + KL, the least-squares
PatchGAN term after reconstruction-only warm-up steps), its decoder
conditioned on the one-hot segmentation; the LDM scale factor is 1/std(z)
of a batch's latents; stage 2 trains a SPADEDiffusionModelUNet on the
latent through `LatentDiffusionInferer` with the segmentation driving its
up path's SPADE norms; `--sample` draws two images through the latent
chain (DDPM, 1000 steps) and the SPADE decode. Widths are the JAX
recipe's: AEKL (32, 64, 64), latent 3, PatchGAN 32 channels, 3 layers,
instance norm; UNet (64, 128) with attention (heads of 128) on its 8x8
level, which stays on the plain path.

On `--device` (default cuda), with `train_2d_ldm`'s stage steps: the
models are initialised from seed 0, the images, segmentations and every
step's draws come from one generator seeded 42 on the device.

`one_hot_labels` and `synthetic_seg_batch` are the recipe's data: blob
images whose intensity, cut into `label_nc` bands, is the label map; with
`--data-dir/--label-dir` (`make_seg_batch_fn`) the training batches are
paired files through `data.paired_stream` instead, fitted by `--fit`.

Usage:
    python -m generativemodels_tpu_torch.recipes.train_spade_ldm --stage1-steps 30 --stage2-steps 30
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..engines import init_adversarial_state
from ..inferers import LatentDiffusionInferer
from ..networks.nets import PatchDiscriminator, SPADEAutoencoderKL, SPADEDiffusionModelUNet
from ..networks.schedulers import DDPMScheduler
from .data_flags import add_data_arguments
from .serve import require_device
from .train_2d_ddpm import synthetic_batch
from .train_2d_ldm import compute_scale_factor, make_stage1_steps, stage2_step, timed


def one_hot_labels(labels: torch.Tensor, label_nc: int) -> torch.Tensor:
    """(B, 1, *spatial) integer label map -> (B, label_nc, *spatial) float one-hot."""
    return F.one_hot(labels[:, 0].long(), label_nc).movedim(-1, 1).float()


def synthetic_seg_batch(generator: torch.Generator, batch: int, size: int, label_nc: int = 3,
                        device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(images, one-hot labels): blob images and their intensity quantised
    into `label_nc` classes (background, outer ring, core)."""
    images = synthetic_batch(generator, batch, size, device)
    labels = torch.clamp((images * label_nc).long(), 0, label_nc - 1)
    return images, one_hot_labels(labels, label_nc)


def make_seg_batch_fn(args, label_nc: int, generator: torch.Generator, device: torch.device):
    """`next_seg_batch()` -> (images, one-hot labels) of `args.batch` on
    `device`: paired `--data-dir/--label-dir` files (sorted-filename
    alignment, labels fitted nearest-neighbour, values clipped to
    `label_nc`) when given, else the synthetic ring-quantised blobs."""
    if not args.data_dir:
        return lambda: synthetic_seg_batch(generator, args.batch, args.size, label_nc, device)
    from ..data import batched_pairs, paired_stream, prefetch_to_device

    shape = (args.batch, 1, args.size, args.size)
    batches = prefetch_to_device(
        ((images.reshape(shape), labels.reshape(shape)) for images, labels in batched_pairs(
            paired_stream(args.data_dir, args.label_dir, (args.size,) * 2, args.fit),
            args.batch)),
        device=device,
    )

    def next_seg_batch():
        images, labels = next(batches)
        labels = torch.clamp(labels, 0, label_nc - 1)
        return images.float(), one_hot_labels(labels, label_nc)

    return next_seg_batch


def spade_aekl_forward(aekl: SPADEAutoencoderKL, inputs: tuple, generator) -> tuple:
    """Stage 1's generator forward on (images, seg): (reconstruction, z_mu, z_sigma)."""
    images, seg = inputs
    return aekl(images, seg, generator=generator)


def build_models(label_nc: int = 3) -> tuple[SPADEAutoencoderKL, PatchDiscriminator,
                                             SPADEDiffusionModelUNet]:
    """The recipe's SPADE AEKL, PatchDiscriminator and latent SPADE UNet."""
    aekl = SPADEAutoencoderKL(
        spatial_dims=2, label_nc=label_nc, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=(32, 64, 64), attention_levels=(False, False, False), latent_channels=3,
        norm_num_groups=32, with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
    )
    disc = PatchDiscriminator(spatial_dims=2, num_channels=32, in_channels=1, num_layers_d=3,
                              norm="INSTANCE")
    unet = SPADEDiffusionModelUNet(
        spatial_dims=2, label_nc=label_nc, in_channels=3, out_channels=3, num_res_blocks=1,
        num_channels=(64, 128), attention_levels=(False, True), num_head_channels=128,
    )
    return aekl, disc, unet


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage1-steps", type=int, default=30)
    parser.add_argument("--stage2-steps", type=int, default=30)
    parser.add_argument("--warmup-steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--label-nc", type=int, default=3)
    parser.add_argument("--kl-weight", type=float, default=1e-6)
    parser.add_argument("--adv-weight", type=float, default=0.01)
    parser.add_argument("--sample", action="store_true")
    add_data_arguments(parser, labels=True)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: list[str] | None = None) -> dict:
    """Train both stages (and sample with `--sample`); returns {"aekl",
    "unet", "scale_factor", "stage1_losses", "stage1_seconds",
    "stage2_losses", "stage2_seconds", "sample" (or None)}."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    if bool(args.data_dir) != bool(args.label_dir):
        parser.error("--data-dir and --label-dir must be given together")
    device = require_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    label_nc = args.label_nc
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        aekl, disc, unet = (m.to(device).train() for m in build_models(label_nc))
    generator = torch.Generator(device).manual_seed(42)

    next_seg_batch = make_seg_batch_fn(args, label_nc, generator, device)

    # stage 1: the adversarial SPADE AutoencoderKL
    state = init_adversarial_state(aekl, torch.optim.Adam(aekl.parameters(), lr=2e-4),
                                   disc, torch.optim.Adam(disc.parameters(), lr=4e-4))
    warm_step, adv_step = make_stage1_steps(args.kl_weight, args.adv_weight,
                                            g_forward=spade_aekl_forward)
    out = dict(stage1_losses=[], stage1_seconds=[], stage2_losses=[], stage2_seconds=[],
               sample=None)
    for i in range(args.stage1_steps):
        images, seg = next_seg_batch()
        step_fn = warm_step if i < args.warmup_steps else adv_step
        (state, step_out), seconds = timed(device, step_fn, state, (images, seg), images,
                                           generator)
        out["stage1_losses"].append({k: float(step_out[k]) for k in (
            "reconstruction_loss", "generator_loss", "discriminator_loss")})
        out["stage1_seconds"].append(seconds)
        if (i + 1) % 10 == 0:
            print(f"[stage1] step {i + 1} "
                  f"recon={out['stage1_losses'][-1]['reconstruction_loss']:.4f}")

    # the scale factor, then stage 2: the SPADE UNet on the latent
    aekl.eval()
    with torch.no_grad():
        z = aekl.encode_stage_2_inputs(next_seg_batch()[0], generator=generator)
    scale_factor = float(compute_scale_factor(z))
    print(f"scale_factor = {scale_factor:.4f}")
    latent_shape = (args.batch,) + tuple(z.shape[1:])
    inferer = LatentDiffusionInferer(DDPMScheduler(num_train_timesteps=1000, device=device),
                                     scale_factor=scale_factor)
    optimizer = torch.optim.Adam(unet.parameters(), lr=1e-4)
    for i in range(args.stage2_steps):
        images, seg = next_seg_batch()
        loss, seconds = timed(device, stage2_step, unet, optimizer, aekl, inferer, images,
                              latent_shape, generator, 1000, seg)
        out["stage2_losses"].append(float(loss))
        out["stage2_seconds"].append(seconds)
        if (i + 1) % 10 == 0:
            print(f"[stage2] step {i + 1} loss={float(loss):.4f}")

    if args.sample:
        unet.eval()
        _, seg = synthetic_seg_batch(generator, 2, args.size, label_nc, device)
        noise = torch.randn((2,) + tuple(z.shape[1:]), generator=generator, device=device)
        with torch.no_grad():
            samples = inferer.sample(noise, aekl, unet, seg=seg, generator=generator)
        print(f"samples: shape={tuple(samples.shape)} std={float(samples.std()):.3f}")
        out["sample"] = samples
    print("done")
    out.update(aekl=aekl, unet=unet, scale_factor=scale_factor)
    return out


if __name__ == "__main__":
    main()
