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
line of kernels 1-4 names its body (`route`: mma or wgmma, as
`ops.attention_route` picks it; a checkout from before it has the mma.sync
bodies alone, but for kernels 2 and 3 where its `backward_route` names
wgmma).
`--kernels` keeps the cases of the kernels named. Prints one JSON object per
case and, with `--out`, appends them to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# (kernel, (BH, Sq, Sk, D), dtype name): kernel 1 at the 3D, serving and 2D
# bench training shapes; kernels 2, 3 and 4 at the 3D shape and the 2D bench
# and recipe training shapes; kernels 1-4 also at the latent UNet's shape and
# the 3D shape's sequence-parallel allgather rows (n = 2): every bf16 D = 64
# shape the main paths give them
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
)
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
        line = dict(root=root, kernel=kernel, shape=[bh, sq, sk, d], dtype=dtype_name, ms=ms,
                    card=card)
        routed = getattr(ops, "attention_route", None)
        if routed is None and kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            routed = getattr(ops, "backward_route", None)
        line["route"] = "wgmma" if routed and routed(dtype, d) == 1 else "mma"
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
