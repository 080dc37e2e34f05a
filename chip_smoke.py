#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build and check its kernels, serve, train.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. card and build: the card's name and power limit (nvidia-smi), the torch
     and CUDA versions, the TF32 settings, and the builds of
     generativemodels_tpu_torch/csrc/flash_fwd.cu and flash_bwd.cu (one nvcc
     each, started together) with their times and ptxas reports;
  2. kernels against their plain versions: O and lse of the flash-attention
     forward kernel against `flash_attention_reference`, and dq, dk, dv of
     the backward kernels against `flash_attention_backward_reference`, at
     the shapes the serving and training paths and their neighbours use,
     with both times (CUDA events);
  3. serving: `recipes.serve.build_sampler` at the full serving config
     (2D UNet (128, 256, 256), 64x64, batch 4, DDIM-50) with every
     parameter drawn from a seeded generator, behind `start_server`,
     answering /healthz and three POST /sample requests (seeds 0, 1, 0);
     the forward kernel's launches counted over those requests; the kernel
     path held against the plain attention path for one UNet forward and
     for every step of one DDIM-50 chain;
  4. training: (a) `recipes.train_2d_ddpm.main` at its defaults (f32, batch
     64, 64x64) for ten steps, (b) the bench.py config (bf16 compute, batch
     128) through `make_diffusion_train_step` for ten steps, each with the
     three kernels' launches counted over the run; (c) one step's parameter
     gradients with seeded random weights, the kernel path against the
     plain attention path, without and with `use_checkpointing`.
The second-to-last line is one JSON object describing the kernels; the last
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
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
CSRC = "generativemodels_tpu_torch/csrc/"
TPU_KERNELS = "generativemodels_tpu/ops/flash_attention.py"
# JSON name: (launcher in ops, source, the Pallas kernel it replaces)
KERNELS = {
    "flash_fwd": ("FLASH_FWD", "flash_fwd.cu", f"{TPU_KERNELS}:202"),  # _fwd_kernel
    "flash_bwd_dq": ("FLASH_BWD_DQ", "flash_bwd.cu", f"{TPU_KERNELS}:343"),  # _dq_kernel
    "flash_bwd_dkv": ("FLASH_BWD_DKV", "flash_bwd.cu", f"{TPU_KERNELS}:475"),  # _dkv_kernel
}

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
# (name, (BH, Sq, Sk, D), dtype name, causal) of the backward kernels
BACKWARD_CASES = (
    ("train_bench_bf16", (128, 1024, 1024, 256), "bfloat16", False),  # bench.py, batch 128
    ("train_recipe_f32", (64, 1024, 1024, 256), "float32", False),  # the recipe, batch 64
    ("causal_f32", (4, 1024, 1024, 128), "float32", True),
    ("ragged_cross_f32", (2, 1000, 777, 64), "float32", False),
    ("head64_bf16", (2, 4096, 4096, 64), "bfloat16", False),
)
# max|diff| / max|ref| of dq, dk, dv: f32 sums over 1024+ keys in another
# order; bf16 rounds ds, p and the outputs to bf16
BACKWARD_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE = dict(spatial_dims=2, size=64, channels=(128, 256, 256), norm_groups=32, batch=4,
             ddim_steps=50)
SEEDS = (0, 1, 0)
# per UNet forward at 64x64: down_1.attn_0, up_1.attn_0 and up_1.attn_1 run
# at 32x32 = 1024 tokens (the 16x16 level and the mid block stay plain)
LAUNCHES_PER_FORWARD = 3
FORWARD_RTOL = 1e-4  # kernel path vs plain path, one UNet forward, relative to max |out|
CHAIN_ATOL = 1e-3  # the same for each step of a DDIM-50 chain, absolute
TRAIN_STEPS = 10
# bench.py's training config: the recipe's model in bf16 compute at batch 128
BENCH = dict(channels=(128, 256, 256), size=64, batch=128, lr=2.5e-5)
GRAD_BATCH = 4
GRAD_RTOL = 1e-3  # kernel path vs plain path, max|diff| / max|grad| of every parameter


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


def check_backward(torch, ops) -> dict:
    """Phase 2, backward: dq of kernel 2 and dk, dv of kernel 3 against the
    plain backward, from the forward kernel's O and log2 lse."""
    from generativemodels_tpu_torch.ops.flash_attention import _backward_rows, _prescaled

    results = {}
    g = torch.Generator("cuda").manual_seed(1)
    for name, (bh, sq, sk, d), dtype_name, causal in BACKWARD_CASES:
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=g, device="cuda").to(dtype)

        q, k, v, dout = rand(sq), rand(sk), rand(sk), rand(sq)
        scale = d**-0.5
        out, lse2 = ops.FLASH_FWD(q, k, v, scale=scale, causal=causal, log2_lse=True)
        qp = _prescaled(q, scale)
        do2, delta = _backward_rows(out, dout)

        def dq_kernel():
            return ops.FLASH_BWD_DQ(qp, k, v, do2, lse2, delta, causal=causal)

        def dkv_kernel():
            return ops.FLASH_BWD_DKV(qp, k, v, do2, lse2, delta, causal=causal)

        def plain():
            return ops.flash_attention_backward_reference(qp, k, v, out, lse2, dout, causal=causal)

        got = (dq_kernel(), *dkv_kernel())
        want = plain()
        torch.cuda.synchronize()
        abs_err, rel_err = {}, {}
        for label, a, b in zip(("dq", "dk", "dv"), got, want):
            abs_err[label] = (a.float() - b.float()).abs().max().item()
            rel_err[label] = abs_err[label] / b.float().abs().max().item()
        del got, want
        ms_dq, ms_dkv, plain_ms = time_ms(dq_kernel), time_ms(dkv_kernel), time_ms(plain)
        tol = BACKWARD_TOLERANCE[dtype_name]
        ok = all(e <= tol for e in rel_err.values())
        log(f"backward {name}: (BH={bh}, Sq={sq}, Sk={sk}, D={d}) {dtype_name} causal={causal} "
            + " ".join(f"max|d{x[1:]}|/max={rel_err[x]:.3e}" for x in ("dq", "dk", "dv"))
            + f" tol={tol:g}; dq kernel {ms_dq:.4f} ms, dkv kernel {ms_dkv:.4f} ms "
            f"(sum {ms_dq + ms_dkv:.4f}), plain backward {plain_ms:.4f} ms -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"backward case {name} out of tolerance")
        results[name] = dict(
            dq=dict(max_abs_err=abs_err["dq"], ms=ms_dq, plain_ms=plain_ms),
            dkv=dict(max_abs_err=max(abs_err["dk"], abs_err["dv"]), ms=ms_dkv, plain_ms=plain_ms),
        )
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


def reset_launches(ops) -> None:
    for launcher, _, _ in KERNELS.values():
        getattr(ops, launcher).launches = 0


def read_launches(ops) -> dict:
    return {name: getattr(ops, launcher).launches for name, (launcher, _, _) in KERNELS.items()}


def check_launches(counts: dict, expected: dict, what: str) -> None:
    log(f"train: {what}: launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{what}: kernel launches {counts}, expected {expected}")


def train_recipe(torch, ops, recipe) -> dict:
    """Phase 4 (a): the recipe's main at its defaults for TRAIN_STEPS steps."""
    reset_launches(ops)
    t0 = time.perf_counter()
    out = recipe.main(["--steps", str(TRAIN_STEPS), "--device", DEVICE])
    seconds = time.perf_counter() - t0
    counts = read_launches(ops)
    losses, sps = out["losses"], out["steps_per_sec"]
    log(f"train: recipe main, defaults (f32, UNet (128, 256, 256), 64x64, batch 64, lr 2.5e-5), "
        f"{TRAIN_STEPS} steps in {seconds:.2f} s (first steps include cuDNN set-up); "
        f"{sps:.3f} steps/s over steps 3-{TRAIN_STEPS}; losses "
        + ", ".join(f"{x:.5f}" for x in losses))
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"recipe losses not finite: {losses}")
    per_step = dict(flash_fwd=3, flash_bwd_dq=3, flash_bwd_dkv=3)
    check_launches(counts, {n: c * TRAIN_STEPS for n, c in per_step.items()}, "recipe main")
    return dict(launches=counts, steps_per_sec=sps)


def train_bench(torch, ops, nets, parallel, schedulers) -> float:
    """Phase 4 (b): bench.py's config (bf16 compute, batch 128) through
    make_diffusion_train_step; returns steps/s over the steps after two."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = nets.DiffusionModelUNet(
            spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=BENCH["channels"], attention_levels=(False, True, True),
            num_head_channels=BENCH["channels"][-1], dtype=torch.bfloat16,
        )
    model = model.to(DEVICE).train()
    step = parallel.make_diffusion_train_step(
        schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    )
    state = parallel.init_train_state(model, torch.optim.Adam(model.parameters(), lr=BENCH["lr"]))
    g = torch.Generator(DEVICE).manual_seed(2)
    images = torch.rand((BENCH["batch"], 1, BENCH["size"], BENCH["size"]), generator=g,
                        device=DEVICE)
    reset_launches(ops)
    losses = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, images, g)
        losses.append(loss)
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    sps = (TRAIN_STEPS - 2) / (time.perf_counter() - t0)
    counts = read_launches(ops)
    losses = [float(x) for x in losses]
    log(f"train: bench.py config (bf16 compute, batch {BENCH['batch']}, 64x64) through "
        f"make_diffusion_train_step: {sps:.3f} steps/s over steps 3-{TRAIN_STEPS}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
        + ", ".join(f"{x:.5f}" for x in losses))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bench-config losses not finite: {losses}")
    check_launches(counts, {n: 3 * TRAIN_STEPS for n in KERNELS}, "bench config")
    del state, model
    torch.cuda.empty_cache()
    return sps


def check_gradients(torch, ops, nets, parallel, schedulers, recipe) -> None:
    """Phase 4 (c): one step's parameter gradients with seeded random weights,
    the kernel path (without and with use_checkpointing) against the plain
    attention path, from the same images, noise and timesteps."""
    cfg = dict(
        spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
        num_channels=BENCH["channels"], attention_levels=(False, True, True),
        num_head_channels=BENCH["channels"][-1], norm_num_groups=32,
    )
    kernel_model = nets.DiffusionModelUNet(**cfg).to(DEVICE)
    randomize(torch, kernel_model)
    models = {}
    for label, extra in (("plain", dict(use_flash_attention=False)),
                         ("checkpointed", dict(use_checkpointing=True))):
        m = nets.DiffusionModelUNet(**cfg, **extra)
        m.load_state_dict(kernel_model.state_dict(), strict=True)
        models[label] = m.to(DEVICE)
    step = parallel.make_diffusion_train_step(
        schedulers.DDPMScheduler(num_train_timesteps=1000, device=DEVICE)
    )
    g = torch.Generator(DEVICE).manual_seed(3)
    images = recipe.synthetic_batch(g, GRAD_BATCH, BENCH["size"], DEVICE) * 2 - 1
    noise = torch.randn(images.shape, generator=g, device=DEVICE)
    timesteps = torch.randint(0, 1000, (GRAD_BATCH,), generator=g, device=DEVICE)

    def grads(model):
        model.zero_grad(set_to_none=True)
        step.loss_fn(model, images, noise, timesteps).backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    want = grads(models["plain"])
    # the to_k biases' gradient is zero in exact arithmetic (softmax ignores a
    # shift shared by all keys): each parameter's error is taken relative to
    # its largest gradient, but to no less than 1e-3 of the model's largest
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    for label, model, fwd in (("kernel path", kernel_model, 3),
                              ("kernel path, use_checkpointing", models["checkpointed"], 6)):
        reset_launches(ops)
        got = grads(model)
        counts = read_launches(ops)
        worst, worst_name = 0.0, ""
        for n, w in want.items():
            rel = (got[n] - w).abs().max().item() / max(w.abs().max().item(), floor)
            if rel > worst:
                worst, worst_name = rel, n
        log(f"train: gradients at batch {GRAD_BATCH}, {label} vs plain path: worst "
            f"max|diff|/max|grad| = {worst:.3e} at {worst_name} (tol {GRAD_RTOL:g})")
        check_launches(counts, dict(flash_fwd=fwd, flash_bwd_dq=3, flash_bwd_dkv=3),
                       f"one step, {label}")
        if not worst <= GRAD_RTOL:
            raise AssertionError(f"{label}: gradients disagree with the plain path")


def build_kernels(build_library) -> None:
    """Phase 1: one nvcc for each source, all started together."""
    results = {}

    def build(name):
        t0 = time.perf_counter()
        try:
            lib, build_log = build_library(name)
            results[name] = (lib, build_log, time.perf_counter() - t0)
        except Exception as exc:  # reported and re-raised below, in this thread
            results[name] = exc

    threads = [threading.Thread(target=build, args=(name,)) for name in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in SOURCES:
        if isinstance(results[name], Exception):
            raise results[name]
        lib, build_log, seconds = results[name]
        log(f"build: {lib.name} in {seconds:.2f} s")
        for line in build_log.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")


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
    from generativemodels_tpu_torch import ops, parallel
    from generativemodels_tpu_torch.networks import nets, schedulers
    from generativemodels_tpu_torch.ops.native import build_library
    from generativemodels_tpu_torch.recipes import serve
    from generativemodels_tpu_torch.recipes import train_2d_ddpm as recipe

    # phase 1: card and build
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32} (full float32)")
    build_kernels(build_library)

    # phase 2: kernels against their plain versions
    forward = check_kernel(torch, ops)
    backward = check_backward(torch, ops)

    # phase 3: serving through its entry points
    served = run_slice(torch, ops, serve, nets)
    log(f"slice: seconds per DDIM-{SERVE['ddim_steps']} request at batch {SERVE['batch']}: "
        + ", ".join(f"{s:.3f}" for s in served["seconds_per_request"]))

    # phase 4: training through its entry points
    trained = train_recipe(torch, ops, recipe)
    train_bench(torch, ops, nets, parallel, schedulers)
    check_gradients(torch, ops, nets, parallel, schedulers, recipe)

    # the numbers of each kernel at its main path's shape: serving for the
    # forward, the recipe's batch 64 for the backward; launches from the
    # recipe's run
    numbers = dict(
        flash_fwd=forward["serve_f32"],
        flash_bwd_dq=backward["train_recipe_f32"]["dq"],
        flash_bwd_dkv=backward["train_recipe_f32"]["dkv"],
    )
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=CSRC + source, replaces=replaces,
             launches=trained["launches"][name], **numbers[name])
        for name, (_, source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
