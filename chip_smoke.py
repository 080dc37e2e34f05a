#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build and check its kernel, then serve.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. card and build: the card's name and power limit (nvidia-smi), the torch
     and CUDA versions, the TF32 settings, and the build of
     generativemodels_tpu_torch/csrc/flash_fwd.cu with its time;
  2. kernel against its plain version: O and lse of the flash-attention
     forward kernel against `flash_attention_reference` at the shapes the
     serving path and its neighbours use, with both times (CUDA events);
  3. the slice: `recipes.serve.build_sampler` at the full serving config
     (2D UNet (128, 256, 256), 64x64, batch 4, DDIM-50) with every
     parameter drawn from a seeded generator, behind `start_server`,
     answering /healthz and three POST /sample requests (seeds 0, 1, 0);
     the kernel's launches counted over those requests; the kernel path
     held against the plain attention path for one UNet forward and for
     every step of one DDIM-50 chain.
The second-to-last line is one JSON object describing the kernel; the last
line is {"ok": true, "device": {...}}. Without a CUDA device the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import base64
import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
KERNEL_SOURCE = "generativemodels_tpu_torch/csrc/flash_fwd.cu"
REPLACES = "generativemodels_tpu/ops/flash_attention.py:202"  # _fwd_kernel

# (name, (BH, Sq, Sk, D), dtype name, causal)
KERNEL_CASES = (
    ("serve_f32", (4, 1024, 1024, 256), "float32", False),
    ("serve_bf16", (4, 1024, 1024, 256), "bfloat16", False),
    ("level2_f32", (4, 256, 256, 256), "float32", False),
    ("head64_bf16", (2, 4096, 4096, 64), "bfloat16", False),
    ("causal_f32", (4, 1024, 1024, 128), "float32", True),
    ("ragged_cross_f32", (2, 1000, 777, 64), "float32", False),
)
# f32: the kernel and the plain version differ only in summation order;
# bf16: O is rounded to bf16 (one ulp near 1 is 2**-7), lse stays f32
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE = dict(spatial_dims=2, size=64, channels=(128, 256, 256), norm_groups=32, batch=4,
             ddim_steps=50)
SEEDS = (0, 1, 0)
# per UNet forward at 64x64: down_1.attn_0, up_1.attn_0 and up_1.attn_1 run
# at 32x32 = 1024 tokens (the 16x16 level and the mid block stay plain)
LAUNCHES_PER_FORWARD = 3
FORWARD_RTOL = 1e-4  # kernel path vs plain path, one UNet forward, relative to max |out|
CHAIN_ATOL = 1e-3  # the same for each step of a DDIM-50 chain, absolute


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernel(torch, ops) -> dict:
    """Phase 2: each case's kernel output against the plain version."""
    results = {}
    g = torch.Generator("cuda").manual_seed(0)
    for name, (bh, sq, sk, d), dtype_name, causal in KERNEL_CASES:
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=g, device="cuda").to(dtype)

        q, k, v = rand(sq), rand(sk), rand(sk)
        scale = d**-0.5
        o, lse = ops.FLASH_FWD(q, k, v, scale=scale, causal=causal)
        o_ref, lse_ref = ops.flash_attention_reference(q, k, v, scale=scale, causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        tol = TOLERANCE[dtype_name]
        ms = time_ms(lambda: ops.FLASH_FWD(q, k, v, scale=scale, causal=causal))
        plain_ms = time_ms(
            lambda: ops.flash_attention_reference(q, k, v, scale=scale, causal=causal)
        )
        ok = err_o <= tol and err_lse <= tol and bool(torch.isfinite(o.float()).all())
        log(f"kernel {name}: (BH={bh}, Sq={sq}, Sk={sk}, D={d}) {dtype_name} causal={causal} "
            f"max|dO|={err_o:.3e} max|dlse|={err_lse:.3e} tol={tol:g} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel case {name} out of tolerance")
        results[name] = dict(max_abs_err=max(err_o, err_lse), ms=ms, plain_ms=plain_ms)
    return results


def randomize(torch, model, seed: int = 1234) -> None:
    """Fill every parameter from a seeded generator: a fresh UNet returns
    exactly 0 (zero-initialised out conv), which would make the checks empty.

    Weights are drawn at 1/sqrt(fan_in), and the attention's to_q and to_k
    at half that. At full scale the random DDIM chain drives natural
    attention logits to ~68, past the kernel contract's clamp (log2 score 80,
    natural ~55), where the clamped softmax departs from the exact one by
    design; at half scale they stay inside it, as in a trained model."""
    g = torch.Generator("cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.ndim >= 2:
                r = r / p[0].numel() ** 0.5
                if name.endswith(("to_q.weight", "to_k.weight")):
                    r = 0.5 * r
            elif name.endswith("weight"):  # GroupNorm scale
                r = 1.0 + 0.1 * r
            else:
                r = 0.1 * r
            p.copy_(r)


# loopback only: never route the requests through a proxy from the environment
_http = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def post_sample(port: int, seed: int, n: int) -> np.ndarray:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sample", data=json.dumps({"n": n, "seed": seed}).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with _http.open(req, timeout=600) as resp:
        body = json.loads(resp.read())
    return np.load(io.BytesIO(base64.b64decode(body["data_b64"])))


def chain_step_diff(scheduler, model_a, model_b, noise) -> float:
    """Run model_a's DDIM chain; at every step also step model_b from the
    same x_t. Returns the largest difference of the two steps' outputs."""
    x, worst = noise, 0.0
    for t in scheduler.timesteps:
        tt = t.expand(x.shape[0])
        xa, _ = scheduler.step(model_a(x, tt), t, x)
        xb, _ = scheduler.step(model_b(x, tt), t, x)
        worst = max(worst, (xa - xb).abs().max().item())
        x = xa
    return worst


def run_slice(torch, ops, serve, nets) -> dict:
    """Phase 3: the serving path over HTTP, then kernel path vs plain path."""
    t0 = time.perf_counter()
    sampler, shape = serve.build_sampler(device=DEVICE, **SERVE)
    randomize(torch, sampler.model)
    log(f"slice: built sampler {shape} DDIM-{SERVE['ddim_steps']} in "
        f"{time.perf_counter() - t0:.2f} s")

    state = serve._SamplerState(sampler, shape)
    httpd = serve.start_server(state, port=0)
    try:
        with _http.open(f"http://127.0.0.1:{httpd.server_port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        log(f"slice: /healthz -> {health}")
        if health["status"] != "ok" or health["shape"] != list(shape):
            raise AssertionError(f"bad /healthz answer {health}")

        ops.FLASH_FWD.launches = 0
        images, seconds = [], []
        for seed in SEEDS:
            t0 = time.perf_counter()
            images.append(post_sample(httpd.server_port, seed, shape[0]))
            seconds.append(time.perf_counter() - t0)
        launches = ops.FLASH_FWD.launches
    finally:
        httpd.shutdown()
        httpd.server_close()

    for seed, img, s in zip(SEEDS, images, seconds):
        log(f"slice: POST /sample seed={seed} -> {img.shape} {img.dtype} in {s:.3f} s "
            f"(range {img.min():.4f} .. {img.max():.4f})")
    expected = LAUNCHES_PER_FORWARD * SERVE["ddim_steps"] * len(SEEDS)
    log(f"slice: flash_fwd launches over {len(SEEDS)} DDIM-{SERVE['ddim_steps']} batches: "
        f"{launches} (expected {expected}, {LAUNCHES_PER_FORWARD * SERVE['ddim_steps']} a batch)")
    for img in images:
        if img.shape != shape or not np.isfinite(img).all():
            raise AssertionError(f"bad image batch: shape {img.shape}, finite {np.isfinite(img).all()}")
    if not np.array_equal(images[0], images[2]):
        raise AssertionError("seed 0 gave different images on two requests")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("seeds 0 and 1 gave identical images")
    if launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times, expected {expected}")

    # the same weights on the plain attention path
    plain = nets.DiffusionModelUNet(
        spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=SERVE["channels"], attention_levels=(False, True, True),
        num_head_channels=SERVE["channels"][-1], norm_num_groups=SERVE["norm_groups"],
        use_flash_attention=False,
    )
    plain.load_state_dict(sampler.model.state_dict(), strict=True)
    plain = plain.to(DEVICE).eval()
    g = torch.Generator(DEVICE).manual_seed(7)
    x = torch.randn(shape, generator=g, device=DEVICE)
    t = torch.tensor([999, 500, 250, 10], device=DEVICE)
    with torch.inference_mode():
        a, b = sampler.model(x, t), plain(x, t)
        fwd_rel = ((a - b).abs().max() / b.abs().max()).item()
        noise = torch.randn(shape, generator=g, device=DEVICE)
        step_abs = chain_step_diff(sampler.inferer.scheduler, sampler.model, plain, noise)
        chain_plain = sampler.inferer.sample(noise, plain)
        free_abs = (sampler.inferer.sample(noise, sampler.model) - chain_plain).abs().max().item()
        # the plain path against itself from noise moved by 1e-6: how far the
        # chain itself spreads a difference of the forward's size
        nudged = noise + 1e-6 * torch.randn(shape, generator=g, device=DEVICE)
        spread_abs = (sampler.inferer.sample(nudged, plain) - chain_plain).abs().max().item()
    log(f"slice: kernel path vs plain path, one UNet forward: max|diff|/max|out| = "
        f"{fwd_rel:.3e} (tol {FORWARD_RTOL:g})")
    log(f"slice: kernel path vs plain path, every step of a DDIM-{SERVE['ddim_steps']} chain "
        f"from the same x_t: max|diff| = {step_abs:.3e} (tol {CHAIN_ATOL:g})")
    log(f"slice: kernel path vs plain path, two free-running DDIM-{SERVE['ddim_steps']} chains: "
        f"max|diff| = {free_abs:.3e}; plain path from noise moved by 1e-6: max|diff| = "
        f"{spread_abs:.3e} (not checked: it measures how the random-weight chain spreads "
        f"small differences, not the kernel)")
    if not fwd_rel <= FORWARD_RTOL:
        raise AssertionError("UNet forward: kernel path disagrees with the plain path")
    if not step_abs <= CHAIN_ATOL:
        raise AssertionError("DDIM chain: kernel path disagrees with the plain path")
    return dict(launches=launches, seconds_per_request=seconds)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "generativemodels_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from generativemodels_tpu_torch import ops
    from generativemodels_tpu_torch.networks import nets
    from generativemodels_tpu_torch.ops.native import build_library
    from generativemodels_tpu_torch.recipes import serve

    # phase 1: card and build
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32} (full float32)")
    t0 = time.perf_counter()
    lib, build_log = build_library("flash_fwd.cu")
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 2: kernel against its plain version
    kernel = check_kernel(torch, ops)

    # phase 3: the slice through its entry points
    served = run_slice(torch, ops, serve, nets)
    log(f"slice: seconds per DDIM-{SERVE['ddim_steps']} request at batch {SERVE['batch']}: "
        + ", ".join(f"{s:.3f}" for s in served["seconds_per_request"]))

    main_case = kernel["serve_f32"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": served["launches"], "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
