"""Entry points that time the attention-forward probe kernels (kernels 6 and 7).

Counterparts of benchmarks/probe_overlap.py and benchmarks/probe_attn_vpu.py,
with the same shape (BH, S, D) = (2, 32768, 64) bf16 (the 3D UNet's
attention), the same variants in the same order, and the same check against
an exact f32 softmax on a slice of the tokens:

    python -m generativemodels_tpu_torch.probes.probe_overlap [variant ...]
    python -m generativemodels_tpu_torch.probes.probe_attn_vpu [variant ...]

Each prints one JSON line a variant: {"variant", "ms", "maxdiff_vs_einsum",
"maxdiff_vs_plain", "rows_vs_plain", "device"}. `ms` is the time of one call
on the card, from CUDA events around ITERS calls after WARMUP (the JAX
scripts' difference of two scan lengths paid for a dispatch path the card
does not have); on `--device cpu` it is the host clock's and no device time.
`maxdiff_vs_plain` is the call's distance from the plain PyTorch version on
the slice (`ops.flash_probes.relative_error`). `--device` defaults to cuda
and fails without a card; `--out PATH` writes the results as a JSON list,
and without it nothing is written. This module holds what the two share.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.flash_probes import relative_error

WARMUP = 3  # calls before the timed ones
ITERS = 20  # timed calls a variant
SEED = 0


def build_argparser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=description, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("variants", nargs="*", help="variants to run (default: all, in order)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="write the results here as a JSON list")
    return parser


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {name}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes time the card's kernels "
                         "(--device cpu runs their plain versions)")
    return device


def random_inputs(bh: int, seq: int, d: int, device: torch.device, seed: int = SEED):
    """q, k, v (bh, seq, d) bf16, standard normal from a numpy generator."""
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal((bh, seq, d), dtype=np.float32))
        .to(torch.bfloat16).to(device)
        for _ in range(3)
    )


def exact_attention(q, k, v, scale: float) -> torch.Tensor:
    """The f32 softmax attention the JAX scripts' einsum computes."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v.float())


def time_ms(fn, device: torch.device, iters: int) -> float:
    """Milliseconds a call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(parser: argparse.ArgumentParser, argv, variants, shape, ref_tokens: int,
        make_calls) -> list[dict]:
    """The probes' main: parse `argv`, make the seeded inputs of `shape` (BH,
    S, D), take the exact reference on the first `ref_tokens` tokens, then for
    each selected variant check its call on that slice against the plain
    version and the reference, and time it on the full inputs (1 + WARMUP +
    ITERS calls a variant). `make_calls(name, scale)` returns the variant's
    call, its plain call (O and the row sums to hold O by, or None) and
    whether to check it against the reference."""
    args = parser.parse_args(argv)
    unknown = [name for name in args.variants if name not in variants]
    if unknown:
        parser.error(f"unknown variants {unknown}; choose from {list(variants)}")
    device = resolve_device(args.device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    bh, seq, d = shape
    scale = d**-0.5
    results = []
    with torch.no_grad():
        inputs = random_inputs(bh, seq, d, device)
        sliced = tuple(t[:, :min(ref_tokens, seq)].contiguous() for t in inputs)
        ref = exact_attention(*sliced, scale)
        for name in args.variants or variants:
            fn, plain, check_ref = make_calls(name, scale)
            got = fn(*sliced)
            want, l = plain(*sliced)
            err_plain, rows = relative_error(got, want, l)
            entry = {
                "variant": name,
                "ms": time_ms(lambda: fn(*inputs), device, ITERS),
                "maxdiff_vs_einsum": (got.float() - ref).abs().max().item() if check_ref else None,
                "maxdiff_vs_plain": err_plain,
                "rows_vs_plain": rows,
                "device": kind,
            }
            print(json.dumps(entry), flush=True)
            results.append(entry)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results
