"""Sampling server: a DDIM or DPM-Solver++ sampler behind a tiny HTTP API.

Counterpart of generativemodels_tpu/recipes/serve.py. The model and the
sampling plan live on `--device` (default cuda); each request runs the
reverse chain eagerly, and the UNet's long-sequence self-attention goes
through the hand-written flash-attention kernel on CUDA. `--solver`
picks DDIM (default), DPM-Solver++ (2M) (`dpmsolver`) or its SDE variant
(`sde-dpmsolver`); `--ddim-steps` is the step count for any solver.

API:
    GET  /healthz            -> {"status": "ok", "batch": B, "shape": [...]}
    POST /sample             -> body {"n": 2, "seed": 123}; returns JSON
                                {"shape", "dtype", "data_b64"} where
                                data_b64 is a base64 .npy of (n, C, *spatial)

Usage:
    python -m generativemodels_tpu_torch.recipes.serve --device cuda --port 8765
    python -m generativemodels_tpu_torch.recipes.serve --oneshot --out sample.npy
    python -m generativemodels_tpu_torch.recipes.serve --solver dpmsolver --ddim-steps 10

Not ported yet: `--checkpoint-dir` and `--export-path`.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..inferers import DiffusionInferer
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDIMScheduler, DPMSolverMultistepScheduler

SOLVERS = ("ddim", "dpmsolver", "sde-dpmsolver")


def require_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; raises if it is CUDA and there is no GPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
    return device


class Sampler:
    """`sampler(seed) -> (B, 1, *spatial)` images from a fixed model and plan."""

    def __init__(self, model: DiffusionModelUNet, inferer: DiffusionInferer, shape, device):
        self.model = model
        self.inferer = inferer
        self.shape = shape
        self.device = device

    @torch.inference_mode()
    def __call__(self, seed: int) -> torch.Tensor:
        generator = torch.Generator(self.device).manual_seed(seed)
        noise = torch.randn(self.shape, generator=generator, device=self.device)
        return self.inferer.sample(noise, self.model, generator=generator)


def build_sampler(
    *,
    spatial_dims: int = 2,
    size: int = 64,
    channels: tuple[int, ...] = (128, 256, 256),
    norm_groups: int = 32,
    batch: int = 1,
    ddim_steps: int = 50,
    device: torch.device | str = "cuda",
    solver: str = "ddim",
) -> tuple[Sampler, tuple[int, ...]]:
    """Build the sampler and its output shape (B, 1, *spatial).

    `solver` is one of SOLVERS; `ddim_steps` is its step count. The
    model's weights are PyTorch's default initialisation from seed 0.
    """
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    device = require_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = DiffusionModelUNet(
            spatial_dims=spatial_dims, in_channels=1, out_channels=1,
            num_res_blocks=1, num_channels=tuple(channels),
            attention_levels=(False,) + (True,) * (len(channels) - 1),
            num_head_channels=channels[-1], norm_num_groups=norm_groups,
        )
    model = model.to(device).eval()
    shape = (batch, 1) + (size,) * spatial_dims
    if solver == "ddim":
        scheduler = DDIMScheduler(num_train_timesteps=1000, device=device)
    else:
        scheduler = DPMSolverMultistepScheduler(
            num_train_timesteps=1000, device=device,
            algorithm_type="sde-dpmsolver++" if solver == "sde-dpmsolver" else "dpmsolver++",
        )
    scheduler.set_timesteps(ddim_steps)
    return Sampler(model, DiffusionInferer(scheduler), shape, device), shape


class _SamplerState:
    """Sampler + a lock serialising device compute."""

    def __init__(self, fn, shape):
        self.fn = fn
        self.shape = shape
        self.lock = threading.Lock()
        self.served = 0

    def sample(self, n: int, seed: int) -> np.ndarray:
        batch = self.shape[0]
        outs = []
        with self.lock:
            for i in range((n + batch - 1) // batch):
                outs.append(self.fn(seed + i).cpu().numpy())
            self.served += n
        return np.concatenate(outs, axis=0)[:n]


def _make_handler(state: _SamplerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "batch": state.shape[0],
                    "shape": list(state.shape),
                    "served": state.served,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                n = int(req.get("n", 1))
                seed = int(req.get("seed", 0))
                if n < 1 or n > 64 * state.shape[0]:
                    raise ValueError(f"n out of range: {n}")
            except (ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            try:
                imgs = state.sample(n, seed)
            except Exception as e:  # device OOM, kernel launch failure, ...
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            buf = io.BytesIO()
            np.save(buf, imgs)
            self._json(200, {
                "shape": list(imgs.shape),
                "dtype": str(imgs.dtype),
                "data_b64": base64.b64encode(buf.getvalue()).decode(),
            })

    return Handler


def start_server(state: _SamplerState, port: int = 0) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; returns it (``.server_port``)."""
    httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--spatial-dims", type=int, default=2, choices=[2, 3])
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--channels", type=int, nargs="+", default=[128, 256, 256])
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--batch", type=int, default=1,
                        help="serving batch (requests round up)")
    parser.add_argument("--ddim-steps", type=int, default=50,
                        help="sampling step count (any --solver)")
    parser.add_argument("--solver", type=str, default="ddim", choices=SOLVERS,
                        help="dpmsolver = DPM-Solver++ (2M), sde-dpmsolver its SDE variant")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--oneshot", action="store_true",
                        help="sample one batch and exit (no HTTP)")
    parser.add_argument("--out", type=str, default="sample.npy")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = require_device(args.device)
    # full float32 matmuls and convolutions, as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, shape = build_sampler(
        spatial_dims=args.spatial_dims, size=args.size, channels=tuple(args.channels),
        norm_groups=args.norm_groups, batch=args.batch, ddim_steps=args.ddim_steps,
        device=device, solver=args.solver,
    )

    t0 = time.time()
    first = fn(args.seed).cpu()
    print(f"warmup sample ({tuple(first.shape)}, {args.solver}-{args.ddim_steps}): "
          f"{time.time() - t0:.1f}s (kernel build included on a first run)")

    if args.oneshot:
        np.save(args.out, first.numpy())
        print(f"wrote {args.out}")
        return

    state = _SamplerState(fn, shape)
    httpd = start_server(state, args.port)
    print(f"serving on http://127.0.0.1:{httpd.server_port} "
          f"(POST /sample {{\"n\": 1, \"seed\": 0}})")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        httpd.shutdown()


if __name__ == "__main__":
    main()
