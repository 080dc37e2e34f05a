"""Probe: how much does the softmax cost on top of the tensor-core products,
and do restructurings that let the two overlap pay? (kernel 6)

Counterpart of benchmarks/probe_overlap.py, on the card: the max-free
clamped exp2 attention forward (`ops.flash_overlap`, csrc/flash_probes.cu)
in seven variants,

  full      - prescaled q, p = bf16(exp2(min(s, 80))), l from a ones column
  mxu_only  - p = bf16(s): the products alone, no clamp or exp2 (garbage
              output by design: the floor of the two products)
  ilv2      - the 64-key step in 2 sub-tiles: all QK products first, then
              each sub-tile's exp2 and its PV products
  ilv4      - the same with 4 sub-tiles
  q2        - two 16-row q fragments a warp sharing every K/V fragment read
  bf16dom   - clamp and exp2 on packed bf16 scores (ex2.approx.ftz.bf16x2)
  ilv2_bf16 - both

each checked against an exact f32 softmax on the first 4096 tokens (except
mxu_only) and against its plain version there, then timed at (2, 32768,
32768, 64) bf16. Usage:

    python -m generativemodels_tpu_torch.probes.probe_overlap [variant ...]
        [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import functools
import sys

from ..ops.flash_probes import OVERLAP_VARIANTS, flash_overlap, flash_overlap_reference
from . import build_argparser, run

BH, SEQ, D = 2, 32768, 64
VARIANTS = OVERLAP_VARIANTS
REF_TOKENS = 4096  # the JAX probe's slice: big enough for its widest key tile


def _calls(name: str, scale: float):
    def plain(q, k, v):
        out, l = flash_overlap_reference(q, k, v, scale=scale, variant=name, with_l=True)
        return out, (l if name == "mxu_only" else None)

    fn = functools.partial(flash_overlap, scale=scale, variant=name)
    return fn, plain, name != "mxu_only"


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the selected variants (all by default); returns their results."""
    return run(build_argparser(__doc__), argv, VARIANTS, (BH, SEQ, D), REF_TOKENS, _calls)


if __name__ == "__main__":
    main(sys.argv[1:])
