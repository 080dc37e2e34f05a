"""2D SPADE VAE-GAN training recipe (semantic image synthesis).

Counterpart of generativemodels_tpu/recipes/train_spade_vae.py: a SPADENet
(VAE mode, (16, 32, 64), z 32) trained against a two-scale
MultiScalePatchDiscriminator (16 channels, 3 layers, instance norm, average
pooling) that judges image + label pairs, with the hinge loss summed over
scales, Pix2PixHD feature matching over each scale's intermediates, the
network's KLD term and an L1 term. One step updates G and then D, in the
JAX step's order: D's logits and features of the real pairs (constants),
G's forward and loss through D as it was, G's update, then D's loss on the
real and the detached fake pairs and D's update.

On `--device` (default cuda): the models are initialised from seed 0, the
images, segmentations and latent draws come from one generator seeded 42
on the device.

Not ported yet: `--data-dir/--label-dir/--fit` (paired real images and
label maps through `data/`).

Usage:
    python -m generativemodels_tpu_torch.recipes.train_spade_vae --steps 30
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from ..engines.trainer import frozen
from ..losses import PatchAdversarialLoss, feature_matching_loss
from ..networks.nets import MultiScalePatchDiscriminator, SPADENet
from .serve import require_device
from .train_2d_ldm import timed
from .train_spade_ldm import synthetic_seg_batch


class SPADEVAEState(NamedTuple):
    net: SPADENet
    g_optimizer: torch.optim.Optimizer
    disc: MultiScalePatchDiscriminator
    d_optimizer: torch.optim.Optimizer
    step: int


class SPADEVAEStep:
    """`step(state, images, seg, generator) -> (state, outputs)`: one G and
    one D update; `outputs` holds "g_total", "d_total", "kld",
    "feature_matching_loss" and "generator_loss"."""

    def __init__(self, kld_weight: float = 1e-5, fm_weight: float = 10.0) -> None:
        self.adv = PatchAdversarialLoss(criterion="hinge", reduction="sum")
        self.kld_weight = kld_weight
        self.fm_weight = fm_weight

    def __call__(self, state: SPADEVAEState, images: torch.Tensor, seg: torch.Tensor,
                 generator: torch.Generator | None = None) -> tuple[SPADEVAEState, dict]:
        net, disc, adv = state.net, state.disc, self.adv

        def d_apply(img):
            return disc(torch.cat([img, seg], dim=1))

        with torch.no_grad():
            _, real_feats = d_apply(images)

        state.g_optimizer.zero_grad(set_to_none=True)
        fake, kld = net(seg, images, generator=generator)
        with frozen(disc):
            fake_logits, fake_feats = d_apply(fake)
        g_adv = adv(fake_logits, target_is_real=True, for_discriminator=False)
        fm = sum(feature_matching_loss(rf, ff) for rf, ff in zip(real_feats, fake_feats))
        fm = fm / len(real_feats)
        recon = torch.mean(torch.abs(fake - images))
        g_total = g_adv + self.fm_weight * fm + self.kld_weight * kld + recon
        g_total.backward()
        state.g_optimizer.step()

        fake = fake.detach()
        state.d_optimizer.zero_grad(set_to_none=True)
        fake_logits, _ = d_apply(fake)
        real_logits, _ = d_apply(images)
        d_total = 0.5 * (adv(real_logits, True, True) + adv(fake_logits, False, True))
        d_total.backward()
        state.d_optimizer.step()

        outputs = {"g_total": g_total.detach(), "d_total": d_total.detach(),
                   "kld": kld.detach(), "feature_matching_loss": fm.detach(),
                   "generator_loss": g_adv.detach()}
        return state._replace(step=state.step + 1), outputs


def build_models(size: int = 64, label_nc: int = 3,
                 z_dim: int = 32) -> tuple[SPADENet, MultiScalePatchDiscriminator]:
    """The recipe's SPADENet and two-scale discriminator."""
    net = SPADENet(spatial_dims=2, in_channels=1, out_channels=1, label_nc=label_nc,
                   input_shape=(size, size), num_channels=(16, 32, 64), z_dim=z_dim,
                   is_vae=True)
    disc = MultiScalePatchDiscriminator(
        num_d=2, num_layers_d=3, spatial_dims=2, num_channels=16, in_channels=1 + label_nc,
        norm="INSTANCE", minimum_size_im=size, pooling_method="AVG",
    )
    return net, disc


def main(argv: list[str] | None = None) -> dict:
    """Train; returns {"state", "outputs" (floats, one dict a step),
    "seconds" (one a step), "sample" (with `--sample`, else None)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--label-nc", type=int, default=3)
    parser.add_argument("--z-dim", type=int, default=32)
    parser.add_argument("--sample", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net, disc = (m.to(device).train() for m in build_models(args.size, args.label_nc,
                                                                args.z_dim))
    state = SPADEVAEState(net, torch.optim.Adam(net.parameters(), lr=2e-4),
                          disc, torch.optim.Adam(disc.parameters(), lr=4e-4), 0)
    step = SPADEVAEStep()
    generator = torch.Generator(device).manual_seed(42)
    history, seconds = [], []
    for i in range(args.steps):
        images, seg = synthetic_seg_batch(generator, args.batch, args.size, args.label_nc, device)
        (state, out), sec = timed(device, step, state, images, seg, generator)
        history.append({k: float(v) for k, v in out.items()})
        seconds.append(sec)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1} g={history[-1]['g_total']:.4f} d={history[-1]['d_total']:.4f} "
                  f"kld={history[-1]['kld']:.4f}")
    sample = None
    if args.sample:
        images, seg = synthetic_seg_batch(generator, 2, args.size, args.label_nc, device)
        with torch.no_grad():
            sample = net(seg, images, generator=generator)[0]
        print(f"synthesis: shape={tuple(sample.shape)} std={float(sample.std()):.3f}")
    print("done")
    return dict(state=state, outputs=history, seconds=seconds, sample=sample)


if __name__ == "__main__":
    main()
