"""Pre-registered quality eval for the brain-MRI 3D LDM bundle config.

Counterpart of generativemodels_tpu/recipes/eval_brain_ldm.py. The
reference bundle publishes FID 0.0076 / MS-SSIM 0.6555 / 4-G-R-SSIM 0.3883
on UK Biobank (model-zoo brain_image_synthesis_latent_diffusion_model
metadata.json:21-25); this recipe pins the comparison protocol:

  - `msssim`: mean 3D MS-SSIM over disjoint pairs of volumes generated
    with distinct random covariates (diversity; compare to 0.6555).
  - `msssim_4g`: mean 3D MS-SSIM over pairs generated with identical
    covariates but different noise (compare to 0.3883).
  - `fid`: between the generated and the real volumes' pooled
    MedicalNet-ResNet10 features when `--data-dir` (real .nii volumes) is
    given, with `--fid-weights` (medicalnet_resnet10_23datasets.pth) or a
    trunk drawn from seed 7, marked not comparable.

Model: the `brain_3d_ldm` preset through `brain_ldm_sampler` (UNet (256,
512, 768) over a (3, 20, 28, 20) latent conditioned on 4 covariates,
DDIM-50, the AEKL decode to 160x224x160), its UNet rebuilt with 3 input
channels as the JAX recipe runs it (the covariates enter through
cross-attention only); `--latent-shape` / `--tiny` shrink it for smoke
runs. `--weights` loads a `torch.save`d dict {"unet": state dict, "aekl":
state dict}; without it the weights are PyTorch's initialisation (seeds 0
and 1) and the output is marked plumbing-only. The attention runs at head
widths 512 and 768, which the flash kernels do not take: the plain path.
The fused ResnetBlock route (GMTPU_FUSED_RESBLOCK=1) stays off unless set.

Usage:
    python -m generativemodels_tpu_torch.recipes.eval_brain_ldm --tiny \\
        --sample-count 4 --out brain_quality.json --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import load_preset
from ..metrics import FIDMetric, MultiScaleSSIMMetric
from .brain_ldm_sampler import brain_autoencoder, brain_unet, sample_brain_ldm
from .eval_quality import feature_trunk, ms_ssim_weights_for
from .serve import require_device

BUNDLE_LATENT = (3, 20, 28, 20)  # bundle latent (160/8, 224/8, 160/8)
TINY_UNET = dict(num_channels=(8, 8), attention_levels=(False, True), num_head_channels=8,
                 norm_num_groups=8)
TINY_AEKL = dict(num_channels=(8, 8), attention_levels=(False, False), norm_num_groups=8)


def make_3d_feature_extractor(weights_path: str | None = None, seed: int = 7,
                              device: torch.device | str = "cuda"):
    """MedicalNet-ResNet10-trunk feature fn: (B, 1, D, H, W) -> (B, 512), on `device`."""
    module = feature_trunk(3, "basic", (1, 1, 1, 1), weights_path, "medicalnet_resnet10", seed,
                           device)

    @torch.inference_mode()
    def features(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=device, dtype=torch.float32)
        # MedicalNet's z-score normalisation over the whole batch (reference
        # perceptual.py:210-214; jnp.std, the population std)
        x = (x - x.mean()) / (x.std(correction=0) + 1e-8)
        return module(x).mean(dim=(2, 3, 4))

    return features


def build_models(tiny: bool, dtype: torch.dtype | None):
    """The preset's UNet (3 input channels, seed 0) and AutoencoderKL (seed
    1), narrowed by `--tiny`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        unet = brain_unet(dtype=dtype, **(TINY_UNET if tiny else {}))
        torch.manual_seed(1)
        aekl = brain_autoencoder(dtype=dtype, **(TINY_AEKL if tiny else {}))
    return unet, aekl


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sample-count", type=int, default=8,
                        help="volumes with distinct covariates (diversity set)")
    parser.add_argument("--same-cond-pairs", type=int, default=2,
                        help="extra pairs sharing covariates (4-G metric)")
    parser.add_argument("--ddim-steps", type=int, default=50)
    parser.add_argument("--latent-shape", type=int, nargs=3, default=None,
                        help="override the (3, D, H, W) latent spatial dims")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny nets + latent for CPU smoke runs")
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    parser.add_argument("--weights", type=str, default=None,
                        help="torch.save'd dict with the state dicts 'unet' and 'aekl'")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="real .nii volumes for the FID real set")
    parser.add_argument("--fid-weights", type=str, default=None,
                        help="medicalnet_resnet10_23datasets.pth for FID features")
    parser.add_argument("--out", type=str, default="brain_quality.json")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: list[str] | None = None) -> dict:
    """Sample, score; writes the JSON result to `--out` and returns it with
    "diverse" (the (B, 1, D, H, W) diversity set, float32 on the device) and
    "seconds" (host clock: "sample" a volume, "msssim", "fid") added."""
    args = build_argparser().parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    unet, aekl = build_models(args.tiny, dtype)
    latent_spatial = tuple(args.latent_shape or ((4, 4, 4) if args.tiny else BUNDLE_LATENT[1:]))
    scheduler = load_preset("brain_3d_ldm").resolve("scheduler")
    latent_shape = (1, 3) + latent_spatial

    plumbing_only = True
    if args.weights:
        trees = torch.load(args.weights, map_location="cpu", weights_only=True)
        unet.load_state_dict(trees["unet"])
        aekl.load_state_dict(trees["aekl"])
        plumbing_only = False
    unet, aekl = unet.to(device).eval(), aekl.to(device).eval()

    generator = torch.Generator(device).manual_seed(42)

    @torch.inference_mode()
    def sample(cond: torch.Tensor) -> torch.Tensor:
        gender, age, ventricular_vol, brain_vol = (float(c) for c in cond)
        return sample_brain_ldm(
            unet, aekl, scheduler, latent_shape, gender=gender, age=age,
            ventricular_vol=ventricular_vol, brain_vol=brain_vol,
            num_inference_steps=args.ddim_steps, generator=generator, device=device,
        ).float()

    def covariates() -> torch.Tensor:
        return torch.rand((4,), generator=generator, device=device)

    t0 = time.time()
    diverse = torch.cat([sample(covariates()) for _ in range(args.sample_count)])
    same_groups = []
    for _ in range(args.same_cond_pairs):
        cond = covariates()
        same_groups.append((sample(cond), sample(cond)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sample_s = time.time() - t0

    t0 = time.time()
    size = min(diverse.shape[2:])
    # the 11-tap Wang window needs >= 11 px; tiny smoke volumes shrink it
    win = 11 if size >= 11 else max(3, (size // 2) * 2 - 1)
    ms_ssim = MultiScaleSSIMMetric(
        spatial_dims=3, data_range=float(diverse.max() - diverse.min()) or 1.0,
        weights=ms_ssim_weights_for(size), kernel_size=win,
    )
    half = diverse.shape[0] // 2
    msssim = float(torch.mean(ms_ssim(diverse[:half], diverse[half: 2 * half])))
    msssim_4g = float(torch.mean(torch.stack([
        torch.mean(ms_ssim(a, b)) for a, b in same_groups
    ]))) if same_groups else None
    msssim_s = time.time() - t0

    fid = None
    fid_features = None
    t0 = time.time()
    if args.data_dir:
        from ..data import batched, training_stream

        # fit real volumes to the generated shape before FID features
        real = torch.from_numpy(next(batched(
            training_stream(args.data_dir, tuple(diverse.shape[2:])), diverse.shape[0],
        )))[:, None].to(device)  # (B, D, H, W) -> (B, 1, D, H, W)
        features = make_3d_feature_extractor(args.fid_weights, device=device)
        fid = float(FIDMetric()(features(diverse), features(real)))
        fid_features = args.fid_weights or (
            "random-init medicalnet trunk (not comparable to published FID)"
        )
    fid_s = time.time() - t0

    result = {
        "preset": "brain_3d_ldm" + (" (tiny)" if args.tiny else ""),
        "published_reference": {
            "fid": 0.0076, "msssim": 0.6555, "4gmsssim": 0.3883,
            "source": "model-zoo brain_image_synthesis_latent_diffusion_model "
                      "metadata.json:21-25",
        },
        "plumbing_only": plumbing_only,
        "sample_count": int(diverse.shape[0]),
        "same_cond_pairs": args.same_cond_pairs,
        "ddim_steps": args.ddim_steps,
        "latent_shape": list(latent_shape),
        "out_shape": list(diverse.shape),
        "sample_seconds": round(sample_s, 1),
        "msssim": msssim,
        "msssim_4g": msssim_4g,
        "fid": fid,
        "fid_features": fid_features,
        "backend": device.type,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    samples = args.sample_count + 2 * args.same_cond_pairs
    return dict(result, diverse=diverse,
                seconds=dict(sample=sample_s / max(1, samples), msssim=msssim_s, fid=fid_s))


if __name__ == "__main__":
    main()
