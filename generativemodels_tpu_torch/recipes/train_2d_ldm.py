"""Two-stage 2D latent diffusion training recipe.

Counterpart of generativemodels_tpu/recipes/train_2d_ldm.py: stage 1 trains
an AutoencoderKL adversarially (PatchGAN, L1 + KL, reconstruction-only
warm-up steps), the LDM scale factor is 1/std(z) of a batch's latents, and
stage 2 trains a diffusion UNet on the latent through
`LatentDiffusionInferer`, the autoencoder's encode a constant. On
`--device` (default cuda); random draws come from `torch.Generator`s in
place of JAX keys: the models are initialised from seed 0, the images and
every step's draws (the stage-1 latent sample; the stage-2 noise, then the
timesteps, then the latent sample) from one generator seeded 42 on the
device. The stage-1 and stage-2 steps here are also those of
`train_3d_ldm`.

`--data-dir` streams .nii/.nii.gz/.npy/PNG/JPEG images through
`data.device_batches` (with `--fit`, `--cache` and `--augment`) in place
of the synthetic ones, in [0, 1] either way.

Usage:
    python -m generativemodels_tpu_torch.recipes.train_2d_ldm --stage1-steps 50 --stage2-steps 50
"""
from __future__ import annotations

import argparse
import time

import torch

from ..engines import AdversarialTrainStep, init_adversarial_state, make_adversarial_train_step
from ..inferers import LatentDiffusionInferer
from ..losses import PatchAdversarialLoss
from ..networks.nets import AutoencoderKL, DiffusionModelUNet, PatchDiscriminator
from ..networks.schedulers import DDPMScheduler
from .data_flags import add_data_arguments, data_batches
from .serve import require_device
from .train_2d_ddpm import synthetic_batch


def compute_scale_factor(latents: torch.Tensor) -> torch.Tensor:
    """The LDM latent scale factor, 1 / std(z) (population std, as jnp.std),
    of a training batch's latents."""
    return 1.0 / torch.std(latents, correction=0)


def aekl_forward(aekl: AutoencoderKL, inputs: torch.Tensor, generator) -> tuple:
    """Stage 1's generator forward: (reconstruction, z_mu, z_sigma), the
    latent sampled from `generator`."""
    return aekl(inputs, generator=generator)


def disc_forward(disc: PatchDiscriminator, images_or_g_out) -> torch.Tensor:
    """The discriminator's prediction on images, or on the reconstruction
    of a generator output."""
    images = images_or_g_out[0] if isinstance(images_or_g_out, tuple) else images_or_g_out
    return disc(images)[-1]


def make_stage1_steps(
    kl_weight: float, adv_weight: float, g_forward=aekl_forward
) -> tuple[AdversarialTrainStep, AdversarialTrainStep]:
    """(reconstruction-only warm-up step, adversarial step): L1 + kl_weight *
    KL for G, plus adv_weight * the least-squares generator loss in the
    adversarial step; D's loss 0.5 * (real + fake) in both. `g_forward`
    gives G's (reconstruction, z_mu, z_sigma) (the SPADE recipe's takes
    (images, seg) inputs)."""
    adv = PatchAdversarialLoss(criterion="least_squares")

    def recon_loss_fn(g_out, targets):
        recon, z_mu, z_sigma = g_out
        l1 = torch.mean(torch.abs(recon - targets))
        kl = 0.5 * torch.mean(z_mu**2 + z_sigma**2 - torch.log(z_sigma**2 + 1e-12) - 1)
        return l1 + kl_weight * kl

    def g_adv_loss(fake_logits):
        return adv(fake_logits, target_is_real=True, for_discriminator=False)

    def d_loss_fn(real_logits, fake_logits):
        return 0.5 * (adv(real_logits, True, True) + adv(fake_logits, False, True))

    def build(weight):
        return make_adversarial_train_step(
            g_forward, disc_forward, recon_loss_fn, g_adv_loss, d_loss_fn, adv_weight=weight
        )

    return build(0.0), build(adv_weight)


def stage2_loss(
    unet: DiffusionModelUNet,
    aekl: AutoencoderKL,
    inferer: LatentDiffusionInferer,
    images: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
    generator: torch.Generator | None,
    seg: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean squared error of the UNet's noise prediction on the encoded
    latent; a SPADE UNet gets `seg`."""
    model = unet if seg is not None else (lambda x, t, context=None: unet(x, t))
    pred = inferer(images, aekl, model, noise, timesteps, seg=seg, generator=generator)
    return torch.mean((pred - noise) ** 2)


def stage2_step(
    unet: DiffusionModelUNet,
    optimizer: torch.optim.Optimizer,
    aekl: AutoencoderKL,
    inferer: LatentDiffusionInferer,
    images: torch.Tensor,
    latent_shape: tuple,
    generator: torch.Generator,
    num_train_timesteps: int = 1000,
    seg: torch.Tensor | None = None,
) -> torch.Tensor:
    """One stage-2 update: the noise, then the timesteps, then (in the
    encode) the latent sample from `generator`; returns the loss. `seg`
    conditions a SPADE UNet."""
    device = images.device
    noise = torch.randn(latent_shape, generator=generator, device=device)
    timesteps = torch.randint(0, num_train_timesteps, (latent_shape[0],), generator=generator,
                              device=device)
    optimizer.zero_grad(set_to_none=True)
    loss = stage2_loss(unet, aekl, inferer, images, noise, timesteps, generator, seg)
    loss.backward()
    optimizer.step()
    return loss.detach()


def timed(device: torch.device, fn, *args):
    """(fn(*args), seconds on the host clock, ending in a synchronize on a card)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def train_ldm(args, device, aekl, disc, unet, lrs: tuple[float, float], next_batch) -> dict:
    """Both stages of the 2D and the 3D recipe; returns {"state" (stage 1's
    AdversarialTrainState), "unet", "scale_factor", "stage1_losses",
    "stage2_losses", "stage1_seconds", "stage2_seconds" (one a step)}."""
    generator = torch.Generator(device).manual_seed(42)
    state = init_adversarial_state(
        aekl, torch.optim.Adam(aekl.parameters(), lr=lrs[0]),
        disc, torch.optim.Adam(disc.parameters(), lr=lrs[1]),
    )
    warm_step, adv_step = make_stage1_steps(args.kl_weight, args.adv_weight)
    stage1_losses, stage1_seconds = [], []
    for i in range(args.stage1_steps):
        images = next_batch(generator)
        step_fn = warm_step if i < args.warmup_steps else adv_step
        (state, out), seconds = timed(device, step_fn, state, images, images, generator)
        stage1_losses.append({k: float(out[k]) for k in (
            "reconstruction_loss", "generator_loss", "discriminator_loss")})
        stage1_seconds.append(seconds)
        if (i + 1) % 10 == 0:
            print(f"[stage1] step {i + 1} recon={stage1_losses[-1]['reconstruction_loss']:.4f} "
                  f"d={stage1_losses[-1]['discriminator_loss']:.4f}")
    result = dict(state=state, unet=unet, scale_factor=None, stage1_losses=stage1_losses,
                  stage2_losses=[], stage1_seconds=stage1_seconds, stage2_seconds=[])
    if args.stage2_steps <= 0:
        print("stage 1 only (autoencoder training) — done")
        return result

    aekl.eval()
    with torch.no_grad():
        z = aekl.encode_stage_2_inputs(next_batch(generator), generator=generator)
    scale_factor = float(compute_scale_factor(z))
    print(f"scale_factor = {scale_factor:.4f}")
    inferer = LatentDiffusionInferer(DDPMScheduler(num_train_timesteps=1000, device=device),
                                     scale_factor=scale_factor)
    optimizer = torch.optim.Adam(unet.parameters(), lr=1e-4)
    unet.train()
    for i in range(args.stage2_steps):
        images = next_batch(generator)
        loss, seconds = timed(device, stage2_step, unet, optimizer, aekl, inferer, images,
                              (args.batch,) + tuple(z.shape[1:]), generator)
        result["stage2_losses"].append(float(loss))
        result["stage2_seconds"].append(seconds)
        if (i + 1) % 10 == 0:
            print(f"[stage2] step {i + 1} loss={float(loss):.4f}")
    result["scale_factor"] = scale_factor
    return result


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage1-steps", type=int, default=50)
    parser.add_argument("--stage2-steps", type=int, default=50)
    parser.add_argument("--warmup-steps", type=int, default=10,
                        help="reconstruction-only steps before the adversarial term")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--kl-weight", type=float, default=1e-6)
    parser.add_argument("--adv-weight", type=float, default=0.01)
    add_data_arguments(parser)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def build_models() -> tuple[AutoencoderKL, PatchDiscriminator, DiffusionModelUNet]:
    """The recipe's AutoencoderKL, PatchDiscriminator and latent UNet, at the
    JAX recipe's widths."""
    aekl = AutoencoderKL(
        spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=(64, 128, 128), attention_levels=(False, False, False),
        latent_channels=3, norm_num_groups=32,
        with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
    )
    disc = PatchDiscriminator(spatial_dims=2, num_channels=32, in_channels=1, num_layers_d=3,
                              norm="INSTANCE")
    unet = DiffusionModelUNet(
        spatial_dims=2, in_channels=3, out_channels=3, num_res_blocks=1,
        num_channels=(64, 128, 128), attention_levels=(False, True, True),
        num_head_channels=128,
    )
    return aekl, disc, unet


def main(argv: list[str] | None = None) -> dict:
    """Train both stages; returns `train_ldm`'s dict."""
    args = build_argparser().parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        aekl, disc, unet = (m.to(device).train() for m in build_models())

    data_iter = data_batches(args, 2, device)

    def next_batch(generator):
        # both paths yield [0, 1] images (the reference 2d_ldm stage-1 range)
        if data_iter is not None:
            return next(data_iter)
        return synthetic_batch(generator, args.batch, args.size, device)

    result = train_ldm(args, device, aekl, disc, unet, (1e-4, 5e-4), next_batch)
    print("done")
    return result


if __name__ == "__main__":
    main()
