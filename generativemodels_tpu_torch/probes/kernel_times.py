"""Time the flash forward (kernel 1), the dq and dK/dV backward (kernels 2
and 3), the fused flash backward (kernel 4) and the fused
GroupNorm-SiLU-conv3d (kernel 5) of one checkout of the port, so that two
checkouts can be compared on one card in one call.

    python generativemodels_tpu_torch/probes/kernel_times.py [--root DIR] [--out FILE]
        [--kernels NAME ...]

`--root` is the root of the checkout whose `generativemodels_tpu_torch` is
imported (default: the checkout holding this file); its kernels are built
from its own sources.
Run it on two checkouts in turns (A, B, B, A) and compare within the call.
Each case is timed with CUDA events over 20 launches after 3, on standard
normal inputs from seed 0 (kernel 5: x and the residual channels-first seen
as NDHWC, as the 3D UNet hands them over, the kernel at 1 / sqrt(27 Cin)); a
line of kernels 1-4 names its body (`route`: mma, wgmma or tf32, as
`ops.attention_route` picks it; a checkout from before it has the mma.sync
bodies alone, but for kernels 2 and 3 where its `backward_route` names
wgmma) and gives the least time the card could take for the same work
(`bound_ms`, `bound_by`: the operations over the bf16 tensor-core rate,
or for f32 over the 3xTF32 rate, against the bytes of the inputs and
outputs once over the memory rate, by chip_smoke.py's `bound`) and the
time of one PyTorch call computing the same function (`library_ms`:
chip_smoke.py's `library_attention_ms`, SDPA's forward for kernel 1 and
its backward, dq, dk and dv, for kernels 2-4, one backend pinned: flash
for bf16, memory-efficient for f32), a yardstick never used by the port.
chip_smoke.py is loaded from the checkout holding this file.
`--kernels` keeps the cases of the kernels named. Prints one JSON object per
case and, with `--out`, appends them to FILE.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# (kernel, (BH, Sq, Sk, D), dtype name): kernel 1 at the 3D, serving and 2D
# bench training shapes; kernels 2, 3 and 4 at the 3D shape and the 2D bench
# and recipe training shapes; kernels 1-4 also at the latent UNet's shape and
# the 3D shape's sequence-parallel allgather rows (n = 2): every bf16 D = 64
# shape the main paths give them; kernels 2 and 3 at the same three shapes in
# f32 (the 3D LDM recipe's f32 stage-1 and stage-2 attention and its cut
# stage-1 step's allgather rows); kernels 2 and 3 at the bf16 D = 256
# contract shapes of chip_smoke.py's phase 2 (d) (the 2D serving shape and
# the conditioned UNets' 77-token context at 4096 queries); and ControlNet's
# f32 head-width-128 shapes: kernel 1 at its sampler's batch 4 (4 launches a
# DDIM step), kernels 1-3 at `recipes/train_controlnet.py`'s batch 16; and
# kernels 2 and 3 at the f32 D = 128 and 256 contract shapes of phase 2 (d)
# (the 2D serving shape, and the causal case's shape without the mask);
# kernel 1 at the 2D f32 recipe's training shape and at the serving shape
# in bf16; kernel 4 in f32 at the 3D LDM's three D = 64 shapes (its TF32
# body), ControlNet's training shape and the f32 D = 128 and 256 contract
# shapes (its mma.sync body)
CASES = (
    ("flash_fwd", (2, 32768, 32768, 64), "bfloat16"),
    ("flash_fwd", (2, 4096, 4096, 64), "bfloat16"),
    ("flash_fwd", (2, 16384, 32768, 64), "bfloat16"),
    ("flash_fwd", (4, 1024, 1024, 256), "float32"),
    ("flash_fwd", (128, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_dq", (2, 32768, 32768, 64), "bfloat16"),
    ("flash_bwd_dq", (2, 4096, 4096, 64), "bfloat16"),
    ("flash_bwd_dq", (2, 16384, 32768, 64), "bfloat16"),
    ("flash_bwd_dq", (128, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_dq", (64, 1024, 1024, 256), "float32"),
    ("flash_bwd_dkv", (2, 32768, 32768, 64), "bfloat16"),
    ("flash_bwd_dkv", (2, 4096, 4096, 64), "bfloat16"),
    ("flash_bwd_dkv", (2, 16384, 32768, 64), "bfloat16"),
    ("flash_bwd_dkv", (128, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_dkv", (64, 1024, 1024, 256), "float32"),
    ("flash_bwd_fused", (2, 32768, 32768, 64), "bfloat16"),
    ("flash_bwd_fused", (2, 4096, 4096, 64), "bfloat16"),
    ("flash_bwd_fused", (2, 16384, 32768, 64), "bfloat16"),
    ("flash_bwd_fused", (128, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_fused", (64, 1024, 1024, 256), "float32"),
    ("flash_bwd_dq", (2, 32768, 32768, 64), "float32"),
    ("flash_bwd_dq", (2, 4096, 4096, 64), "float32"),
    ("flash_bwd_dq", (2, 16384, 32768, 64), "float32"),
    ("flash_bwd_dkv", (2, 32768, 32768, 64), "float32"),
    ("flash_bwd_dkv", (2, 4096, 4096, 64), "float32"),
    ("flash_bwd_dkv", (2, 16384, 32768, 64), "float32"),
    ("flash_bwd_dq", (4, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_dkv", (4, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_dq", (4, 4096, 77, 256), "bfloat16"),
    ("flash_bwd_dkv", (4, 4096, 77, 256), "bfloat16"),
    ("flash_fwd", (4, 1024, 1024, 128), "float32"),
    ("flash_fwd", (16, 1024, 1024, 128), "float32"),
    ("flash_bwd_dq", (16, 1024, 1024, 128), "float32"),
    ("flash_bwd_dkv", (16, 1024, 1024, 128), "float32"),
    ("flash_bwd_dq", (4, 1024, 1024, 256), "float32"),
    ("flash_bwd_dkv", (4, 1024, 1024, 256), "float32"),
    ("flash_bwd_dq", (4, 1024, 1024, 128), "float32"),
    ("flash_bwd_dkv", (4, 1024, 1024, 128), "float32"),
    ("flash_fwd", (64, 1024, 1024, 256), "float32"),
    ("flash_fwd", (4, 1024, 1024, 256), "bfloat16"),
    ("flash_bwd_fused", (2, 32768, 32768, 64), "float32"),
    ("flash_bwd_fused", (2, 4096, 4096, 64), "float32"),
    ("flash_bwd_fused", (2, 16384, 32768, 64), "float32"),
    ("flash_bwd_fused", (16, 1024, 1024, 128), "float32"),
    ("flash_bwd_fused", (4, 1024, 1024, 128), "float32"),
    ("flash_bwd_fused", (4, 1024, 1024, 256), "float32"),
)
# (multiply-adds a (query, key) pair and head column, (sq, sk) rows of
# inputs and outputs of width D) of kernels 1-4: the forward's two products
# (s, o), the dq kernel's three (s, dp, dq), the dk, dv kernel's four, the
# fused kernel's five; each also reads or writes two or one f32 row values
# (lse2 and delta; the lse) of each query
WORK = {"flash_fwd": (2, (2, 2), 4), "flash_bwd_dq": (3, (3, 2), 8),
        "flash_bwd_dkv": (4, (2, 4), 8), "flash_bwd_fused": (5, (3, 4), 8)}
# kernel 5 at the 13 bf16 call shapes of the 3D UNet's forward at 128^3
# (chip_smoke.py's FUSED_CASES): (name, (B, D, H, W), Cin, Cout, residual)
CONV_CASES = (
    ("128_32to32", (1, 128, 128, 128), 32, 32, False),
    ("128_32to32r", (1, 128, 128, 128), 32, 32, True),
    ("128_96to32", (1, 128, 128, 128), 96, 32, False),
    ("128_64to32", (1, 128, 128, 128), 64, 32, False),
    ("64_32to64", (1, 64, 64, 64), 32, 64, False),
    ("64_64to64r", (1, 64, 64, 64), 64, 64, True),
    ("64_192to64", (1, 64, 64, 64), 192, 64, False),
    ("64_96to64", (1, 64, 64, 64), 96, 64, False),
    ("32_64to128", (1, 32, 32, 32), 64, 128, False),
    ("32_128to128r", (1, 32, 32, 32), 128, 128, True),
    ("32_128to128", (1, 32, 32, 32), 128, 128, False),
    ("32_256to128", (1, 32, 32, 32), 256, 128, False),
    ("32_192to128", (1, 32, 32, 32), 192, 128, False),
)
# the backward launchers by kernel name
BACKWARD = {"flash_bwd_dq": "FLASH_BWD_DQ", "flash_bwd_dkv": "FLASH_BWD_DKV",
            "flash_bwd_fused": "FLASH_BWD_FUSED"}


def route_name(ops, kernel: str, dtype, d: int) -> str:
    """The body `kernel` runs for these inputs: `ops.attention_route`'s (by
    kernel where it takes one: a checkout from before the TF32 route passes
    no kernel), or `backward_route`'s for kernels 2 and 3 in a checkout from
    before `attention_route`, else mma.sync."""
    routed = getattr(ops, "attention_route", None)
    if routed is None and kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        routed = getattr(ops, "backward_route", None)
    if routed is None:
        return "mma"
    try:
        route = routed(dtype, d, False, kernel=kernel)
    except TypeError:
        route = routed(dtype, d)
    return {1: "wgmma", 2: "tf32"}.get(route, "mma")


def chip_smoke():
    """The repo's chip_smoke.py, from the checkout holding this file (its
    `bound` and its SDPA yardstick `library_attention_ms`)."""
    spec = importlib.util.spec_from_file_location(
        "kernel_times_chip_smoke", os.path.join(HERE_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bound(smoke, kernel: str, bh: int, sq: int, sk: int, d: int, esize: int) -> dict:
    """The least time the card could take for `kernel`'s work at (BH, Sq,
    Sk, D) without a mask, f32 products counted as 3xTF32."""
    products, (rows_q, rows_k), row_bytes = WORK[kernel]
    nbytes = bh * d * esize * (rows_q * sq + rows_k * sk) + row_bytes * bh * sq
    return smoke.bound(2 * products * bh * sq * sk * d, nbytes,
                       "bfloat16" if esize == 2 else "float32",
                       None if esize == 2 else smoke.PEAK_3XTF32)


def time_ms(torch, fn, iters: int = 20) -> float:
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


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE_ROOT, help="checkout root to import the port from")
    parser.add_argument("--out", default=None, help="append the JSON lines to this file")
    parser.add_argument("--kernels", nargs="*", default=None,
                        help="time only these kernels (flash_fwd, flash_bwd_dq, flash_bwd_dkv, "
                             "flash_bwd_fused, fused_conv)")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("generativemodels_tpu_torch")]:
        del sys.modules[name]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    from generativemodels_tpu_torch import ops
    from generativemodels_tpu_torch.ops.flash_attention import _backward_rows, _prescaled

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    root = os.path.dirname(os.path.dirname(os.path.abspath(ops.__file__)))
    smoke = chip_smoke()
    results = []
    for kernel, (bh, sq, sk, d), dtype_name in CASES:
        if args.kernels is not None and kernel not in args.kernels:
            continue
        dtype = getattr(torch, dtype_name)
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v, dout = (torch.randn((bh, n, d), generator=g, device="cuda").to(dtype)
                         for n in (sq, sk, sk, sq))
        scale = d**-0.5
        if kernel == "flash_fwd":
            ms = time_ms(torch, lambda: ops.FLASH_FWD(q, k, v, scale=scale))
        else:
            out, lse2 = ops.FLASH_FWD(q, k, v, scale=scale, log2_lse=True)
            qp = _prescaled(q, scale)
            do2, delta = _backward_rows(out, dout)
            launcher = getattr(ops, BACKWARD[kernel])
            ms = time_ms(torch, lambda: launcher(qp, k, v, do2, lse2, delta))
            del out, lse2, qp, do2, delta
        lib_ms, backend = smoke.library_attention_ms(
            torch, q, k, v, scale, False, dout=None if kernel == "flash_fwd" else dout)
        line = dict(root=root, kernel=kernel, shape=[bh, sq, sk, d], dtype=dtype_name, ms=ms,
                    **bound(smoke, kernel, bh, sq, sk, d, q.element_size()), library_ms=lib_ms,
                    library=backend, card=card)
        line["route"] = route_name(ops, kernel, dtype, d)
        print(json.dumps(line), flush=True)
        results.append(line)
        del q, k, v, dout
        torch.cuda.empty_cache()
    for name, (b, d, h, w), cin, cout, residual in CONV_CASES:
        if args.kernels is not None and "fused_conv" not in args.kernels:
            break
        g = torch.Generator("cuda").manual_seed(0)

        def rand(*shape, mul=1.0):
            return mul * torch.randn(shape, generator=g, device="cuda")

        x = rand(b, cin, d, h, w).bfloat16().permute(0, 2, 3, 4, 1)
        kernel = rand(3, 3, 3, cin, cout, mul=(27 * cin) ** -0.5).bfloat16()
        scale, shift, bias = 1.0 + 0.1 * rand(b, cin), 0.1 * rand(b, cin), 0.1 * rand(cout)
        res = rand(b, cout, d, h, w).bfloat16().permute(0, 2, 3, 4, 1) if residual else None
        ms = time_ms(torch, lambda: ops.FUSED_CONV(x, kernel, scale, shift, bias, res))
        line = dict(root=root, kernel="fused_conv", case=name, shape=[b, d, h, w, cin, cout],
                    dtype="bfloat16", ms=ms, card=card)
        print(json.dumps(line), flush=True)
        results.append(line)
        del x, kernel, res
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in results:
                f.write(json.dumps(line) + "\n")
    return results


if __name__ == "__main__":
    main()
