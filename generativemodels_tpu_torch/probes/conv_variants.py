"""Price kernel 5 (csrc/fused_conv.cu) by timing variants of its source on
the card, bf16, at the 3D UNet's call shapes.

    python generativemodels_tpu_torch/probes/conv_variants.py price --root DIR [--out FILE]
    python generativemodels_tpu_torch/probes/conv_variants.py split [--out FILE]
    python generativemodels_tpu_torch/probes/conv_variants.py wgmma [--out FILE]

`price` takes a checkout whose kernel 5 is the one-plane-a-block design
(each block loops over its three depth taps and over 16-channel chunks,
then over the 9 in-plane taps of mma.sync: the kernel before its Hopper
redesign) and times, at four 128^3 cases and at 32^3 128->128 with a
residual: the kernel as it is; with `apply_act=0` (no affine, exp or
division); with its tap loop removed (loads, prologue and barriers); and
both.

`split` does the same for this checkout's kernel at three cases, one per
level, with three variants: without its products, without its normalise
pass (the raw halo still lands and is waited for), and without its loads
(no TMA of the raw halo, no copy of the kernel slice: the products run on
stale data, so only the time counts).

`wgmma` takes this checkout's kernel and derives from it the same kernel
with its products on wgmma (m64nNk16, A from the ldmatrix fragments in
registers, B from shared memory through a descriptor, the kernel slice in
the canonical no-swizzle K-major layout), then times both at the 13 bf16
cases with the depth run the tile chooser picks, holding each against the
plain version and checking that two launches agree to the bit.

Each variant is built from a source written next to the kernel under
another name (removed when the run ends) and launched through a subclass of the
checkout's `FusedConvKernel`. Times: CUDA events over 20 launches after 3,
inputs from seed 4 (x and the residual channels-first seen as NDHWC). One
JSON object per case, also appended to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# (name, (B, D, H, W), Cin, Cout, residual)
PRICE_CASES = (
    ("128_32to32", (1, 128, 128, 128), 32, 32, False),
    ("128_32to32r", (1, 128, 128, 128), 32, 32, True),
    ("128_96to32", (1, 128, 128, 128), 96, 32, False),
    ("128_64to32", (1, 128, 128, 128), 64, 32, False),
    ("32_128to128r", (1, 32, 32, 32), 128, 128, True),
)

# the tap loop of the one-plane-a-block kernel, replaced by one read of the
# staged halo and slice (so that the staging stays live)
_TAP_LOOP = "#pragma unroll 1\n      for (int tap = 0; tap < 9; ++tap) {"
_TAP_LOOP_END = "  // epilogue: + bias, + residual, in f32; one cast"
_NO_TAPS = ("acc[0][0][0] += __bfloat162float(sA[threadIdx.x]) "
            "+ __bfloat162float(sB[threadIdx.x]);\n    }\n  }\n\n")

SPLIT_CASES = (
    ("128_96to32", (1, 128, 128, 128), 96, 32, False),
    ("64_192to64", (1, 64, 64, 64), 192, 64, False),
    ("32_256to128", (1, 32, 32, 32), 256, 128, False),
)
# (variant, [(text, replacement)]) of the redesigned kernel for `split`
SPLIT_EDITS = (
    ("no_products", [("    with_plane<kPlanes>(p, [&](auto plane) { products(plane, a_item, "
                      "b_chunk); });", "    (void)a_item;\n    (void)b_chunk;")]),
    ("no_normalise", [("    for (int it = tid; it < 2 * kHalo; it += kThreads) {",
                       "    for (int it = tid; it < 0; it += kThreads) {")]),
    ("no_loads", [("        mbar_expect(&raw_full[stage], kRawElems * sizeof(bf16));\n"
                   "        tma_load_5d(raw, &x_map, &raw_full[stage], w0 - 8, h0 - 1, sd, c0, "
                   "bi);", "        mbar_expect(&raw_full[stage], 0);"),
                  ("      cp_async16(dst + swz(row, 8 * half), src);\n", "")]),
)

# the redesigned kernel's products and the store of its kernel slice
_PRODUCTS = "  auto products = [&](auto plane, uint32_t a_item, uint32_t b_chunk) {"
_PRODUCTS_END = "#pragma unroll 1\n  for (int item = 0; item < items; ++item) {"
_SLICE_STORE = "      cp_async16(dst + swz(row, 8 * half), src);\n"
_HELPERS_AT = "// f(Plane<p>{}) for the runtime p < N"
_WGMMA_PRODUCTS = """  auto products = [&](auto plane, uint32_t a_item, uint32_t b_chunk) {
    constexpr int P = decltype(plane)::value;
    // this warpgroup's kBN / 2 channels of the slice, [tap][n / 8][k half][8][8]
    const uint32_t b_group = b_chunk - b_lane + smem_addr(sW) + wn * (kBN / 16) * 256;
    uint32_t a[2][2][4];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3;
      const int kw = tap % 3;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(a[tap & 1][i], a_item + a_kw[kw] + (kh * kHaloPitch + i * 16) * kChunk * 2);
      }
      asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        if (P - kd < 0 || P - kd >= R) continue;
        const uint64_t desc = wg_desc(b_group + (kd * 9 + tap) * kBN * kChunk * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i) wg_mma<kBN / 2>(acc[P - kd][i], a[tap & 1][i], desc);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  };

"""
_WGMMA_HELPERS = """// wgmma operand B by descriptor: no swizzle, K-major core matrices of 8 rows
// x 16 bytes, 128 bytes apart along K and 256 along N
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16)
         | (static_cast<uint64_t>(256 >> 4) << 32);
}
template <int N>
__device__ __forceinline__ void wg_mma(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                       uint64_t desc);
template <>
__device__ __forceinline__ void wg_mma<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %13, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\\n}\\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

"""


def _between(text: str, start: str, end: str) -> tuple[int, int]:
    i = text.index(start)
    return i, text.index(end, i)


def priced_source(text: str) -> str:
    """The one-plane-a-block kernel with its tap loop (fragment reads and
    products) removed."""
    i, j = _between(text, _TAP_LOOP, _TAP_LOOP_END)
    if not text[i:j].endswith("    }\n  }\n\n"):
        raise ValueError("the tap loop is not where the one-plane-a-block kernel has it")
    return text[:i] + _NO_TAPS + text[j:]


def wgmma_source(text: str) -> str:
    """The redesigned kernel with its products on wgmma (kBN = 32: m64n16k16)."""
    i, j = _between(text, _PRODUCTS, _PRODUCTS_END)
    text = text[:i] + _WGMMA_PRODUCTS + text[j:]
    if _SLICE_STORE not in text or _HELPERS_AT not in text:
        raise ValueError("the kernel slice's store or the helpers moved")
    text = text.replace(_SLICE_STORE, "      cp_async16(dst + (row / kBN) * kBN * kChunk"
                        " + ((row % kBN / 8) * 2 + half) * 64 + (row % 8) * 8, src);\n")
    return text.replace(_HELPERS_AT, _WGMMA_HELPERS + _HELPERS_AT, 1)


def edited_source(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"not in the kernel: {old[:60]!r}")
        text = text.replace(old, new)
    return text


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
    parser.add_argument("mode", choices=("price", "split", "wgmma"))
    parser.add_argument("--root", default=HERE_ROOT, help="checkout root to import the port from")
    parser.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("generativemodels_tpu_torch")]:
        del sys.modules[name]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("conv_variants needs a CUDA device")
    from generativemodels_tpu_torch import ops
    from generativemodels_tpu_torch.ops import fused_conv
    from generativemodels_tpu_torch.ops.native import CSRC_DIR, build_library

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kernel_text = (CSRC_DIR / "fused_conv.cu").read_text()
    if args.mode == "price":
        sources = {"no_products": priced_source(kernel_text)}
    elif args.mode == "split":
        sources = {name: edited_source(kernel_text, edits) for name, edits in SPLIT_EDITS}
    else:
        sources = {"wgmma": wgmma_source(kernel_text)}
    variants, written = {}, []
    try:
        for label, text in sources.items():
            variant_name = f"fused_conv_{label}_variant.cu"
            written.append(CSRC_DIR / variant_name)
            written[-1].write_text(text)
            _, log = build_library(variant_name)
            for line in log.splitlines():
                if "Used" in line or "stack frame" in line or "wgmma" in line:
                    print(label, line.strip(), flush=True)
            variants[label] = type(label, (fused_conv.FusedConvKernel,),
                                   {"source": variant_name})()
        return _run(args, torch, ops, fused_conv, variants, card)
    finally:
        for path in written:
            path.unlink(missing_ok=True)


def _run(args, torch, ops, fused_conv, variants: dict, card: str) -> list[dict]:
    if args.mode == "price":
        cases = PRICE_CASES
    elif args.mode == "split":
        cases = SPLIT_CASES
    else:
        cases = tuple((name, shape, cin, cout, res) for name, shape, cin, cout, res, dtype
                      in _fused_cases() if dtype == "bfloat16")
    results = []
    g = torch.Generator("cuda").manual_seed(4)
    for name, (b, d, h, w), cin, cout, residual in cases:
        def rand(*shape, mul=1.0):
            return mul * torch.randn(shape, generator=g, device="cuda")

        x = rand(b, cin, d, h, w).bfloat16().permute(0, 2, 3, 4, 1)
        kernel = rand(3, 3, 3, cin, cout, mul=(27 * cin) ** -0.5).bfloat16()
        scale, shift, bias = 1.0 + 0.1 * rand(b, cin), 0.1 * rand(b, cin), 0.1 * rand(cout)
        res = rand(b, cout, d, h, w).bfloat16().permute(0, 2, 3, 4, 1) if residual else None
        line = dict(mode=args.mode, case=name, card=card)
        if args.mode == "price":
            other = variants["no_products"]
            for label, launcher, act in (("kernel", ops.FUSED_CONV, True),
                                         ("apply_act0", ops.FUSED_CONV, False),
                                         ("no_products", other, True),
                                         ("neither", other, False)):
                line[label] = time_ms(torch, lambda: launcher(x, kernel, scale, shift, bias, res,
                                                              act))
        elif args.mode == "split":
            line["tile"] = fused_conv.conv_tiles(b, d, h, w, cout)[:2]
            line["kernel"] = time_ms(torch, lambda: ops.FUSED_CONV(x, kernel, scale, shift, bias,
                                                                   res))
            line["apply_act0"] = time_ms(torch, lambda: ops.FUSED_CONV(x, kernel, scale, shift,
                                                                       bias, res, False))
            for label, launcher in variants.items():
                line[label] = time_ms(torch, lambda: launcher(x, kernel, scale, shift, bias, res))
        else:
            other = variants["wgmma"]
            want = ops.fused_norm_silu_conv3d_reference(x, kernel, scale, shift, bias, res)
            ref = want.float().abs().max().item()
            line["tile"] = fused_conv.conv_tiles(b, d, h, w, cout)[:2]
            for label, launcher in (("mma_sync", ops.FUSED_CONV), ("wgmma", other)):
                got, again = (launcher(x, kernel, scale, shift, bias, res) for _ in range(2))
                line[label] = time_ms(torch, lambda: launcher(x, kernel, scale, shift, bias, res))
                line[label + "_rel_err"] = (got.float() - want.float()).abs().max().item() / ref
                line[label + "_bits_equal"] = bool(torch.equal(got, again))
        print(json.dumps(line), flush=True)
        results.append(line)
        del x, kernel, res
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in results:
                f.write(json.dumps(line) + "\n")
    return results


def _fused_cases():
    """chip_smoke.py's FUSED_CASES, from the checkout holding this file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_chip_smoke", os.path.join(HERE_ROOT,
                                                                              "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FUSED_CASES


if __name__ == "__main__":
    main()
