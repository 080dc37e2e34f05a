"""Which body kernels 2 and 3 run: `backward_route` over input type, head
width and contract.

The dq and dk/dv launchers pass `backward_route(q.dtype, D, upcast)` to the
C entry of csrc/flash_bwd.cu: bf16 at head width 64 in the two exp2
contracts takes the wgmma body fed by a TMA ring (ROUTE_WGMMA); f32, the
upcast contract (whose launcher runs f32 inputs) and the other bf16 widths
keep the mma.sync bodies (ROUTE_MMA). The CPU path never reaches a route:
on CPU tensors the ops run the plain backward, which
tests/test_torch_flash_backward.py holds against the JAX backward.
"""
from __future__ import annotations

import pytest
import torch

from generativemodels_tpu_torch.ops import backward_route
from generativemodels_tpu_torch.ops.flash_attention import ROUTE_MMA, ROUTE_WGMMA

# the contracts as the backward launchers take them: (upcast, no_max)
CONTRACTS = {"no_max": (False, True), "running_max": (False, False), "upcast": (True, True)}
# the (dtype, head width, contract) cases on the wgmma body; every other case
# keeps the mma.sync body
WGMMA_CASES = {(torch.bfloat16, 64, "no_max"), (torch.bfloat16, 64, "running_max")}


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_route(dtype, d, contract):
    upcast, _ = CONTRACTS[contract]
    want = ROUTE_WGMMA if (dtype, d, contract) in WGMMA_CASES else ROUTE_MMA
    assert backward_route(dtype, d, upcast) == want
