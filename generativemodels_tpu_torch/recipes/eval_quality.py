"""End-to-end quality loop: train -> sample -> FID / MS-SSIM, one command.

Counterpart of generativemodels_tpu/recipes/eval_quality.py: train a 2D
DDPM (synthetic blobs or `--data-dir`), sample with DDIM (or DPM-Solver++),
then compute
  - FID between the real and the sampled images' features (the ResNet50
    trunk, global-average-pooled; `--fid-weights` loads a torchvision
    resnet50 checkpoint, without it the trunk's weights are drawn from
    seed 7 and the value is only self-consistent within the run), and
  - MS-SSIM diversity over disjoint sample pairs, with scale weights cut
    to what the image size holds.
Results are written as one JSON file with the JAX recipe's keys. The UNet
computes in bf16 over float32 parameters, as the JAX recipe's; at the
defaults (UNet (64, 128, 128), 64x64) its 32x32 level's self-attention is
1024 tokens of head width 128, which runs the flash kernels on CUDA.

Usage:
    python -m generativemodels_tpu_torch.recipes.eval_quality --train-steps 200 --out results.json
"""
from __future__ import annotations

import argparse
import json
import time
import warnings

import torch

from ..inferers import DiffusionInferer
from ..metrics import FIDMetric, MultiScaleSSIMMetric
from ..networks.backbones import ResNetFeatures
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDIMScheduler, DDPMScheduler, DPMSolverMultistepScheduler
from ..parallel import init_train_state, make_diffusion_train_step
from .serve import require_device
from .train_2d_ddpm import synthetic_batch


def make_feature_extractor(weights_path: str | None = None, seed: int = 7,
                           device: torch.device | str = "cuda"):
    """ResNet50-trunk feature fn: (B, 1|3, H, W) -> (B, 2048), on `device`."""
    if not weights_path:
        warnings.warn(
            "make_feature_extractor called without weights_path: the FID trunk runs with "
            "RANDOM ResNet50 weights, so FID values are only self-consistent within this "
            "run, not comparable to any published number. Supply a torchvision resnet50 "
            "checkpoint for real FID.",
            UserWarning,
            stacklevel=2,
        )
    module = feature_trunk(2, "bottleneck", (3, 4, 6, 3), weights_path, "resnet50", seed,
                           device)

    @torch.inference_mode()
    def features(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=device, dtype=torch.float32)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        return module(x).mean(dim=(2, 3))

    return features


def feature_trunk(spatial_dims: int, block: str, layers: tuple, weights_path: str | None,
           network_type: str, seed: int, device) -> ResNetFeatures:
    """The ResNet trunk in eval mode on `device`: a checkpoint's backbone
    weights, or PyTorch's initialisation from `seed`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = ResNetFeatures(spatial_dims=spatial_dims, block=block, layers=layers)
    if weights_path:
        from ..networks.pretrained import _load_state_dict, backbone_state_dict

        module.load_state_dict(backbone_state_dict(_load_state_dict(weights_path), network_type))
    return module.to(device).eval()


def ms_ssim_weights_for(size: int) -> tuple[float, ...]:
    """Truncate the 5-scale Wang weights so the smallest scale fits an 11-tap
    kernel (the reference validates this, ms_ssim.py:108-117)."""
    full = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    scales = 1
    while scales < 5 and (size >> scales) >= 11:
        scales += 1
    w = full[:scales]
    return tuple(x / sum(w) for x in w)


def diversity_ms_ssim(samples: torch.Tensor) -> torch.Tensor:
    """Mean MS-SSIM between the first and the second half of `samples`."""
    ms_ssim = MultiScaleSSIMMetric(
        spatial_dims=samples.ndim - 2, data_range=1.0,
        weights=ms_ssim_weights_for(samples.shape[-1]),
    )
    half = samples.shape[0] // 2
    return torch.mean(ms_ssim(samples[:half], samples[half: 2 * half]))


def evaluate_quality(real: torch.Tensor, samples: torch.Tensor,
                     fid_weights: str | None = None) -> dict:
    """FID + MS-SSIM diversity between a real set and a sample set, on their device."""
    features = make_feature_extractor(fid_weights, device=real.device)
    fid = float(FIDMetric()(features(samples), features(real)))
    return {"fid": fid, "ms_ssim_diversity": float(diversity_ms_ssim(samples))}


# The JAX recipe's pre-registered eval preset: the MedNIST 2D-DDPM tutorial
# config (UNet (128, 256, 256), attention (F, T, T), heads 256, b128, lr
# 2.5e-5, T = 1000, ~28k steps).
PRESETS: dict[str, dict] = {
    "mednist_2d_ddpm": dict(
        batch=128, size=64, channels=[128, 256, 256], norm_groups=32,
        lr=2.5e-5, train_steps=28000, sample_count=1000, sample_batch=100,
        ddim_steps=50,
    ),
}


def build_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="pin a pre-registered eval config; explicit flags still override")
    parser.add_argument("--train-steps", type=int, default=None)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--channels", type=int, nargs="+", default=None)
    parser.add_argument("--norm-groups", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--sample-count", type=int, default=None)
    parser.add_argument("--sample-batch", type=int, default=None)
    parser.add_argument("--ddim-steps", type=int, default=None)
    parser.add_argument("--solver", choices=["ddim", "dpmsolver", "sde-dpmsolver"],
                        default="ddim",
                        help="dpmsolver = DPM-Solver++ (2M) at --ddim-steps steps; "
                        "sde-dpmsolver = its stochastic variant")
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--fid-weights", type=str, default=None)
    parser.add_argument("--out", type=str, default="quality_results.json")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: list[str] | None = None) -> dict:
    """Train, sample, score; writes the JSON result to `--out` and returns it
    with "real" and "samples" (the two image sets, on the device) added."""
    args = build_argparser().parse_args(argv)
    defaults = dict(train_steps=200, batch=64, size=64, channels=[64, 128, 128],
                    norm_groups=32, lr=2.5e-5, sample_count=64, sample_batch=32,
                    ddim_steps=50)
    if args.preset:
        defaults.update(PRESETS[args.preset])
    for k, v in defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    device = require_device(args.device)
    if device.type == "cuda":
        # full float32 matmuls and convolutions, as the JAX reference computes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=tuple(args.channels),
            attention_levels=(False,) + (True,) * (len(args.channels) - 1),
            num_head_channels=args.channels[-1], norm_num_groups=args.norm_groups,
            dtype=torch.bfloat16,
        )
    model = model.to(device).train()
    train_scheduler = DDPMScheduler(num_train_timesteps=1000, device=device)
    step = make_diffusion_train_step(train_scheduler)
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=args.lr))

    data_iter = None
    if args.data_dir:
        from ..data import device_batches

        data_iter = device_batches(args.data_dir, (args.size,) * 2, args.batch, device=device)

    generator = torch.Generator(device).manual_seed(42)
    t0 = time.time()
    loss = torch.tensor(float("nan"))
    real_batches, loss_curve = [], []
    for i in range(args.train_steps):
        if data_iter is not None:
            images = next(data_iter)
        else:
            images = synthetic_batch(generator, args.batch, args.size, device)
        if len(real_batches) * args.batch < args.sample_count:
            real_batches.append(images)
        state, loss = step(state, images, generator)
        if (i + 1) % 50 == 0:
            loss_curve.append([i + 1, round(float(loss), 5)])
            print(f"[train] step {i + 1} loss={float(loss):.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0
    real = torch.cat(real_batches)[: args.sample_count]

    if args.solver in ("dpmsolver", "sde-dpmsolver"):
        sched = DPMSolverMultistepScheduler(
            num_train_timesteps=1000, device=device,
            algorithm_type="sde-dpmsolver++" if args.solver == "sde-dpmsolver" else "dpmsolver++",
        )
    else:
        sched = DDIMScheduler(num_train_timesteps=1000, device=device)
    sched.set_timesteps(args.ddim_steps)
    inferer = DiffusionInferer(sched)
    model.eval()

    t0 = time.time()
    chunks = []
    remaining = args.sample_count
    with torch.inference_mode():
        while remaining > 0:
            n = min(args.sample_batch, remaining)
            noise = torch.randn((args.sample_batch, 1, args.size, args.size),
                                generator=generator, device=device)
            chunks.append(inferer.sample(noise, model, generator=generator)[:n].float())
            remaining -= n
    samples = torch.cat(chunks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sample_s = time.time() - t0

    metrics = evaluate_quality(real, samples, fid_weights=args.fid_weights)
    result = {
        "preset": args.preset,
        "config": f"2D DDPM {tuple(args.channels)} b{args.batch} {args.size}px "
                  f"T=1000 {args.solver.upper()}-{args.ddim_steps}",
        "data": args.data_dir or "synthetic blobs",
        "train_steps": args.train_steps,
        "final_train_loss": float(loss),
        "loss_curve": loss_curve,
        "train_seconds": round(train_s, 1),
        "sample_count": int(samples.shape[0]),
        "sample_seconds": round(sample_s, 1),
        "fid_features": args.fid_weights
        or "random-init resnet50 trunk (not comparable to published FID)",
        **metrics,
        "backend": device.type,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
    return dict(result, real=real, samples=samples)


if __name__ == "__main__":
    main()
