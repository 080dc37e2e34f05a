"""VQ-VAE + autoregressive transformer training recipe (anomaly detection).

Counterpart of generativemodels_tpu/recipes/train_vqvae_transformer.py:
stage 1 trains the VQ-VAE ((64, 128), two residual layers, stride-2
kernel-4 down- and upsampling, `--num-embeddings` codes of 32) on L1 plus
the quantisation loss, its EMA codebook moving in the forward; stage 2
trains a DecoderOnlyTransformer (dim 128, depth 4, 4 heads) on the
raster-ordered codebook indices with BOS teacher forcing (the NLL of each
next token); the likelihood map of a fresh batch closes the run.

On `--device` (default cuda): the models are initialised from seed 0, the
images and the training crops drawn from one generator seeded 42 on the
device. The token grid is (size / 4)^2: at `--size 128` that is 1024
tokens of head width 32, so on CUDA stage 2's causal self-attention runs
the flash kernels 1-3, forward and backward (kernel 4 in place of 2 and 3
under GMTPU_FLASH_FUSED_BWD=1).

Not ported yet: `--data-dir/--fit/--augment/--cache` (real images through
`data/`).

Usage:
    python -m generativemodels_tpu_torch.recipes.train_vqvae_transformer --stage1-steps 50
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..inferers import VQVAETransformerInferer
from ..networks.nets import VQVAE, DecoderOnlyTransformer
from ..utils import Ordering
from .serve import require_device
from .train_2d_ddpm import synthetic_batch
from .train_2d_ldm import timed


def build_models(
    size: int, num_embeddings: int = 64, use_flash_attention: bool | None = None
) -> tuple[VQVAE, DecoderOnlyTransformer]:
    """The recipe's VQ-VAE and transformer for `size`x`size` images (a
    (size / 4)^2 token grid), at the JAX recipe's widths."""
    vqvae = VQVAE(
        spatial_dims=2, in_channels=1, out_channels=1, num_channels=(64, 128),
        num_res_layers=2, num_res_channels=(64, 128),
        downsample_parameters=((2, 4, 1, 1), (2, 4, 1, 1)),
        upsample_parameters=((2, 4, 1, 1, 0), (2, 4, 1, 1, 0)),
        num_embeddings=num_embeddings, embedding_dim=32,
    )
    transformer = DecoderOnlyTransformer(
        num_tokens=num_embeddings + 1, max_seq_len=(size // 4) ** 2, attn_layers_dim=128,
        attn_layers_depth=4, attn_layers_heads=4, use_flash_attention=use_flash_attention,
    )
    return vqvae, transformer


def stage2_loss(inferer, vqvae, transformer, ordering, images, generator) -> torch.Tensor:
    """Mean NLL of each next token under teacher forcing."""
    logits, target, _ = inferer(images, vqvae, transformer, ordering, return_latent=True,
                                generator=generator)
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 2, target[..., None].long()).mean()


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stage1-steps", type=int, default=50)
    parser.add_argument("--stage2-steps", type=int, default=50)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--num-embeddings", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: list[str] | None = None) -> dict:
    """Train both stages; returns {"vqvae", "transformer", "ordering",
    "stage1_losses", "perplexities", "stage1_seconds", "stage2_losses",
    "stage2_seconds" (one a step) and "likelihood" (the (2, g, g) map)}."""
    args = build_argparser().parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vqvae, transformer = (m.to(device) for m in build_models(args.size, args.num_embeddings))
    generator = torch.Generator(device).manual_seed(42)

    def next_batch():
        return synthetic_batch(generator, args.batch, args.size, device)

    # stage 1: L1 + quantisation loss, the EMA codebook moving in the forward
    vqvae.train()
    optimizer = torch.optim.Adam(vqvae.parameters(), lr=1e-4)

    def stage1_step(images):
        optimizer.zero_grad(set_to_none=True)
        recon, qloss = vqvae(images)
        loss = torch.mean(torch.abs(recon - images)) + qloss
        loss.backward()
        optimizer.step()
        return loss.detach(), vqvae.quantizer.perplexity.detach()

    out = dict(stage1_losses=[], perplexities=[], stage1_seconds=[], stage2_losses=[],
               stage2_seconds=[])
    for i in range(args.stage1_steps):
        (loss, perplexity), seconds = timed(device, stage1_step, next_batch())
        out["stage1_losses"].append(float(loss))
        out["perplexities"].append(float(perplexity))
        out["stage1_seconds"].append(seconds)
        if (i + 1) % 10 == 0:
            print(f"[stage1] step {i + 1} loss={float(loss):.4f} "
                  f"perplexity={float(perplexity):.1f}")

    # stage 2: the transformer on the raster-ordered indices
    vqvae.eval()
    grid = (args.size // 4, args.size // 4)
    ordering = Ordering("raster_scan", 2, (1,) + grid)
    inferer = VQVAETransformerInferer()
    transformer.train()
    optimizer2 = torch.optim.Adam(transformer.parameters(), lr=3e-4)

    def stage2_step(images):
        optimizer2.zero_grad(set_to_none=True)
        loss = stage2_loss(inferer, vqvae, transformer, ordering, images, generator)
        loss.backward()
        optimizer2.step()
        return loss.detach()

    for i in range(args.stage2_steps):
        loss, seconds = timed(device, stage2_step, next_batch())
        out["stage2_losses"].append(float(loss))
        out["stage2_seconds"].append(seconds)
        if (i + 1) % 10 == 0:
            print(f"[stage2] step {i + 1} nll={float(loss):.4f}")

    # the anomaly likelihood map of one batch
    transformer.eval()
    images = synthetic_batch(generator, 2, args.size, device)
    ll_map = inferer.get_likelihood(images, vqvae, transformer, ordering)
    print(f"likelihood map {tuple(ll_map.shape)}, mean log-prob {float(ll_map.mean()):.3f}")
    out.update(vqvae=vqvae, transformer=transformer, ordering=ordering, likelihood=ll_map)
    return out


if __name__ == "__main__":
    main()
