"""VQ-GAN training recipe (VQ-VAE + PatchGAN adversarial + feature matching).

Counterpart of generativemodels_tpu/recipes/train_vqgan.py: a VQ-VAE
trained with L1 reconstruction + quantization loss + the least-squares
adversarial loss against a PatchDiscriminator and the Pix2PixHD
feature-matching term, after reconstruction-only warm-up steps. One step
updates G (whose forward moves the EMA codebook) and then D, in the JAX
step's order: D's features of the reals (constants), G's forward and its
loss through D as it was, G's update, then D's loss on the detached fakes
and the reals and D's update. `--spatial-dims 3` trains on volumes; with
`--adv-weight 0` that is the reconstruction-only 3D VQ-VAE tutorial.

On `--device` (default cuda): the models are initialised from seed 0, the
synthetic images drawn from one generator seeded 42 on the device (the
VQ-VAE step draws nothing); `--data-dir` streams .nii/.nii.gz/.npy/PNG/JPEG
images through `data.device_batches` (with `--fit`, `--cache` and
`--augment`) in their place.

Usage:
    python -m generativemodels_tpu_torch.recipes.train_vqgan --steps 50
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from ..engines.trainer import frozen
from ..losses import PatchAdversarialLoss, feature_matching_loss
from ..networks.nets import VQVAE, PatchDiscriminator
from .data_flags import add_data_arguments, data_batches
from .serve import require_device
from .train_2d_ddpm import synthetic_batch
from .train_2d_ldm import timed
from .train_3d_ddpm import synthetic_volume


class VQGANState(NamedTuple):
    vqvae: VQVAE  # its parameters and codebook buffers: the JAX state's g_params, codebook
    g_optimizer: torch.optim.Optimizer
    disc: PatchDiscriminator
    d_optimizer: torch.optim.Optimizer
    step: int


class VQGANStep:
    """`step(state, images) -> (state, outputs)`: one G (+ EMA codebook) and
    one D update; `outputs` holds "g_total", "d_total" and the loss terms.
    The VQ-VAE's codebook moves when it is in training mode."""

    def __init__(self, adv_weight: float = 0.01, fm_weight: float = 1.0,
                 quant_weight: float = 1.0) -> None:
        self.adv = PatchAdversarialLoss(criterion="least_squares")
        self.adv_weight = adv_weight
        self.fm_weight = fm_weight
        self.quant_weight = quant_weight

    def __call__(self, state: VQGANState, images: torch.Tensor) -> tuple[VQGANState, dict]:
        vqvae, disc, adv = state.vqvae, state.disc, self.adv
        with torch.no_grad():
            real_feats = disc(images)[:-1]

        state.g_optimizer.zero_grad(set_to_none=True)
        recon, q_loss = vqvae(images)
        with frozen(disc):
            fake_outs = disc(recon)
        recon_l1 = torch.mean(torch.abs(recon - images))
        g_adv = adv(fake_outs[-1], target_is_real=True, for_discriminator=False)
        fm = feature_matching_loss(real_feats, fake_outs[:-1])
        g_total = (recon_l1 + self.quant_weight * q_loss
                   + self.adv_weight * (g_adv + self.fm_weight * fm))
        g_total.backward()
        state.g_optimizer.step()

        fakes = recon.detach()
        state.d_optimizer.zero_grad(set_to_none=True)
        fake_logits = disc(fakes)[-1]
        real_logits = disc(images)[-1]
        d_total = 0.5 * (adv(real_logits, True, True) + adv(fake_logits, False, True))
        d_total.backward()
        state.d_optimizer.step()

        outputs = {
            "g_total": g_total, "d_total": d_total, "reconstruction_loss": recon_l1,
            "quantization_loss": q_loss, "generator_loss": g_adv,
            "feature_matching_loss": fm,
        }
        return state._replace(step=state.step + 1), {k: v.detach() for k, v in outputs.items()}


def make_vqgan_step(adv_weight: float = 0.01, fm_weight: float = 1.0,
                    quant_weight: float = 1.0) -> VQGANStep:
    """The fused VQ-GAN step; the models and optimizers live in the state."""
    return VQGANStep(adv_weight, fm_weight, quant_weight)


def build_models(spatial_dims: int = 2, channels: tuple = (128, 256)) -> tuple[VQVAE,
                                                                              PatchDiscriminator]:
    """The recipe's VQ-VAE (256 codes of 32, two residual layers a level) and
    PatchDiscriminator (64 channels, 3 layers, instance norm)."""
    vqvae = VQVAE(
        spatial_dims=spatial_dims, in_channels=1, out_channels=1, num_channels=channels,
        num_res_layers=2, num_res_channels=channels,
        downsample_parameters=((2, 4, 1, 1),) * len(channels),
        upsample_parameters=((2, 4, 1, 1, 0),) * len(channels),
        num_embeddings=256, embedding_dim=32,
    )
    disc = PatchDiscriminator(spatial_dims=spatial_dims, num_channels=64, in_channels=1,
                              num_layers_d=3, norm="INSTANCE")
    return vqvae, disc


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"state", "outputs" (one dict of floats a step),
    "seconds" (one a step, host clock ending in a synchronize on a card),
    "codebook_usage" (distinct indices of the last batch)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--warmup-steps", type=int, default=10)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--spatial-dims", type=int, choices=[2, 3], default=2)
    parser.add_argument("--channels", type=int, nargs="+", default=None,
                        help="per-level channels (default: 128 256; the reference "
                        "3d_vqvae uses 256 256)")
    parser.add_argument("--adv-weight", type=float, default=0.01,
                        help="0 disables the GAN term (3d_vqvae tutorial)")
    parser.add_argument("--fm-weight", type=float, default=1.0)
    add_data_arguments(parser)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    channels = tuple(args.channels) if args.channels else (128, 256)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vqvae, disc = (m.to(device).train() for m in build_models(args.spatial_dims, channels))
    state = VQGANState(vqvae, torch.optim.Adam(vqvae.parameters(), lr=1e-4),
                       disc, torch.optim.Adam(disc.parameters(), lr=5e-4), 0)
    warm = make_vqgan_step(adv_weight=0.0, fm_weight=args.fm_weight)
    full = make_vqgan_step(adv_weight=args.adv_weight, fm_weight=args.fm_weight)
    synth = synthetic_volume if args.spatial_dims == 3 else synthetic_batch

    generator = torch.Generator(device).manual_seed(42)
    data_iter = data_batches(args, args.spatial_dims, device)
    history, seconds = [], []
    images = None
    for i in range(args.steps):
        if data_iter is not None:
            images = next(data_iter)
        else:
            images = synth(generator, args.batch, args.size, device)
        step_fn = warm if i < args.warmup_steps else full
        (state, out), dt = timed(device, step_fn, state, images)
        history.append({k: float(v) for k, v in out.items()})
        seconds.append(dt)
        if (i + 1) % 10 == 0:
            h = history[-1]
            print(f"step {i + 1} recon={h['reconstruction_loss']:.4f} "
                  f"quant={h['quantization_loss']:.4f} g_adv={h['generator_loss']:.4f} "
                  f"fm={h['feature_matching_loss']:.4f} d={h['d_total']:.4f}")
    usage = None
    if images is not None:
        with torch.no_grad():
            usage = int(torch.unique(vqvae.index_quantize(images)).numel())
    return dict(state=state, outputs=history, seconds=seconds, codebook_usage=usage)


if __name__ == "__main__":
    main()
