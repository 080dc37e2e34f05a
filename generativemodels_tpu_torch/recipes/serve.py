"""Sampling server: a DDIM or DPM-Solver++ sampler behind a tiny HTTP API.

Counterpart of generativemodels_tpu/recipes/serve.py. The model and the
sampling plan live on `--device` (default cuda); each request runs the
reverse chain eagerly, and the UNet's long-sequence self-attention goes
through the hand-written flash-attention kernel on CUDA. `--solver`
picks DDIM (default), DPM-Solver++ (2M) (`dpmsolver`) or its SDE variant
(`sde-dpmsolver`); `--ddim-steps` is the step count for any solver.
`--checkpoint-dir` serves the weights a training recipe saved there (the
latest step's "params", loaded into the UNet the flags describe);
without it the weights are PyTorch's initialisation from seed 0.
`--export-path F` serves the sampler exported to F (`utils/export.py`, a
`torch.export` `.pt2` file) without building the model when F exists;
otherwise it builds the sampler, exports it to F and serves the export.
An exported sampler takes its noise as input (`SamplerGraph`): the server
draws it from the request's seeded generator in the order the in-process
sampler draws it (`draw_noise`), so a served export returns the
in-process sampler's images to the bit.

API:
    GET  /healthz            -> {"status": "ok", "batch": B, "shape": [...]}
    POST /sample             -> body {"n": 2, "seed": 123}; returns JSON
                                {"shape", "dtype", "data_b64"} where
                                data_b64 is a base64 .npy of (n, C, *spatial)

Usage:
    python -m generativemodels_tpu_torch.recipes.serve --device cuda --port 8765
    python -m generativemodels_tpu_torch.recipes.serve --oneshot --out sample.npy
    python -m generativemodels_tpu_torch.recipes.serve --solver dpmsolver --ddim-steps 10
    python -m generativemodels_tpu_torch.recipes.serve --checkpoint-dir CKPT
    python -m generativemodels_tpu_torch.recipes.serve --export-path sampler.pt2 --oneshot
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
from torch import nn

from ..inferers import DiffusionInferer
from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDIMScheduler, DPMSolverMultistepScheduler
from ..utils import CheckpointManager, ExportedFunction, load_exported, save_exported

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


def draw_noise(shape, seed: int, device, steps: int = 0) -> tuple[torch.Tensor, ...]:
    """A request's noise from a generator seeded with `seed`, in the order
    `Sampler.__call__` and the inferer draw it: the initial noise, then, for
    a sampler that draws `steps` step noises (the SDE solver), one f32
    draw of the image's shape a step, stacked."""
    generator = torch.Generator(device).manual_seed(seed)
    noise = torch.randn(shape, generator=generator, device=device)
    if not steps:
        return (noise,)
    draws = [torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
             for _ in range(steps)]
    return noise, torch.stack(draws)


def noise_steps(sampler: Sampler) -> int:
    """How many step noises the sampler's chain draws (0 unless SDE)."""
    scheduler = sampler.inferer.scheduler
    if getattr(scheduler, "algorithm_type", None) == "sde-dpmsolver++":
        return len(scheduler.timesteps)
    return 0


class SamplerGraph(nn.Module):
    """The sampler as a function of its noise, for `torch.export`:
    `(noise[, step_noise]) -> images`."""

    def __init__(self, sampler: Sampler) -> None:
        super().__init__()
        self.model = sampler.model
        self.inferer = sampler.inferer

    def forward(self, noise: torch.Tensor, step_noise: torch.Tensor | None = None):
        return self.inferer.sample(noise, self.model, step_noise=step_noise)


class ExportedSampler:
    """`sampler(seed) -> images` over an exported `SamplerGraph`; its shape,
    device and step-noise count are read from the export's inputs."""

    def __init__(self, fn: ExportedFunction) -> None:
        self.fn = fn
        (self.shape, _, self.device), *rest = fn.input_specs
        self.steps = rest[0][0][0] if rest else 0
        require_device(self.device)

    @torch.inference_mode()
    def __call__(self, seed: int) -> torch.Tensor:
        return self.fn(*draw_noise(self.shape, seed, self.device, self.steps))


def export_sampler(sampler: Sampler, path: str) -> ExportedSampler:
    """Export `sampler` (traced without gradients) to `path`, a `.pt2` file;
    returns the exported sampler, as a process that loads the file serves it."""
    example = draw_noise(sampler.shape, 0, sampler.device, noise_steps(sampler))
    with torch.no_grad():
        program = save_exported(path, SamplerGraph(sampler), *example)
    return ExportedSampler(ExportedFunction(program))


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
    checkpoint_dir: str | None = None,
) -> tuple[Sampler, tuple[int, ...]]:
    """Build the sampler and its output shape (B, 1, *spatial).

    `solver` is one of SOLVERS; `ddim_steps` is its step count. The
    model's weights are the "params" of the latest checkpoint under
    `checkpoint_dir` (every key of the UNet the arguments describe, no
    other), else PyTorch's default initialisation from seed 0.
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
    if checkpoint_dir:
        mgr = CheckpointManager(checkpoint_dir)
        model.load_state_dict(mgr.restore()["params"])
        mgr.close()
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
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="serve the latest checkpoint a training recipe saved there")
    parser.add_argument("--export-path", type=str, default=None,
                        help="serve the sampler exported here (torch.export); if the file "
                        "does not exist, export the sampler the flags describe to it first")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--oneshot", action="store_true",
                        help="sample one batch and exit (no HTTP)")
    parser.add_argument("--out", type=str, default="sample.npy")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    # full float32 matmuls and convolutions, as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.export_path and os.path.exists(args.export_path):
        # the export's own shape and device win over the flags
        fn = ExportedSampler(load_exported(args.export_path))
        shape = fn.shape
        print(f"serving exported sampler from {args.export_path} (no model build)")
    else:
        fn, shape = build_sampler(
            spatial_dims=args.spatial_dims, size=args.size, channels=tuple(args.channels),
            norm_groups=args.norm_groups, batch=args.batch, ddim_steps=args.ddim_steps,
            device=require_device(args.device), solver=args.solver,
            checkpoint_dir=args.checkpoint_dir,
        )
        if args.export_path:
            t0 = time.time()
            fn = export_sampler(fn, args.export_path)
            print(f"exported sampler -> {args.export_path} ({time.time() - t0:.1f}s, "
                  f"{os.path.getsize(args.export_path)} bytes)")

    t0 = time.time()
    first = fn(args.seed).cpu()
    what = "exported" if isinstance(fn, ExportedSampler) else f"{args.solver}-{args.ddim_steps}"
    print(f"warmup sample ({tuple(first.shape)}, {what}): {time.time() - t0:.1f}s "
          f"(kernel build included on a first run)")

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
