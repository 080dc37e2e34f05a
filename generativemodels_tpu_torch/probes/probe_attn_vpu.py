"""Probe: what does the online-max softmax cost at the 3D attention shape, and
do a prescaled q or a bf16 exp pay? (kernel 7)

Counterpart of benchmarks/probe_attn_vpu.py, on the card:

  base     - the port's flash attention (`ops.flash_attention`, kernel 1) at
             its default contract, as the JAX probe's base runs the JAX one
  prescale - the online-max natural-exp forward (`ops.flash_vpu`,
             csrc/flash_probes.cu) with the scale folded into q first
  bf16p    - the same with p = exp(bf16(s - m)) in packed bf16
  both     - prescale + bf16p

each checked against an exact f32 softmax on the first 2048 tokens and
against its plain version there, then timed at (2, 32768, 32768, 64) bf16.
Usage:

    python -m generativemodels_tpu_torch.probes.probe_attn_vpu [variant ...]
        [--device cuda|cpu] [--out PATH]
"""
from __future__ import annotations

import functools
import sys

from ..ops.flash_attention import flash_attention, flash_attention_reference
from ..ops.flash_probes import VPU_VARIANTS, flash_vpu, flash_vpu_reference
from . import build_argparser, run

BH, SEQ, D = 2, 32768, 64
VARIANTS = ("base", *VPU_VARIANTS)
REF_TOKENS = 2048  # the JAX probe's slice


def _calls(name: str, scale: float):
    if name == "base":
        return (functools.partial(flash_attention, scale=scale),
                lambda q, k, v: (flash_attention_reference(q, k, v, scale=scale)[0], None),
                True)
    prescaled, bf16_p = VPU_VARIANTS[name]
    opts = dict(scale=scale, prescaled=prescaled, bf16_p=bf16_p)
    return (functools.partial(flash_vpu, **opts),
            lambda q, k, v: (flash_vpu_reference(q, k, v, **opts), None),
            True)


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the selected variants (all by default); returns their results."""
    return run(build_argparser(__doc__), argv, VARIANTS, (BH, SEQ, D), REF_TOKENS, _calls)


if __name__ == "__main__":
    main(sys.argv[1:])
