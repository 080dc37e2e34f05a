"""Which body kernels 1-4 run: `attention_route` over input type, head width
and contract, and the launchers that hand it to their C entries.

The forward, dq, dk/dv and fused launchers pass `attention_route(q.dtype,
D, upcast)` to the C entries of csrc/flash_fwd.cu and csrc/flash_bwd.cu:
bf16 at head width 64 in the two exp2 contracts takes the wgmma bodies fed
by a TMA ring (ROUTE_WGMMA); f32, the upcast contract (whose launchers run
f32 inputs) and the other bf16 widths keep the mma.sync bodies (ROUTE_MMA).
The CPU path never reaches a route: on CPU tensors the ops run the plain
versions, which tests/test_torch_flash_attention.py and
tests/test_torch_flash_backward.py hold against the JAX kernels. Here each
launcher's C call is caught before it leaves Python (its checks of CUDA
inputs and its `_launch` stood in for), so the route it would pass, and the
number of arguments its C entry declares, are read on the CPU.
"""
from __future__ import annotations

import importlib

import pytest
import torch

from generativemodels_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_BWD_FUSED,
    FLASH_FWD,
    attention_route,
)
from generativemodels_tpu_torch.ops.flash_attention import (
    FUSED_DQ_GROUPS,
    ROUTE_MMA,
    ROUTE_WGMMA,
)

# the module, which `ops` shadows with its function of the same name
flash_module = importlib.import_module("generativemodels_tpu_torch.ops.flash_attention")

# the contracts as the launchers take them: (upcast, no_max)
CONTRACTS = {"no_max": (False, True), "running_max": (False, False), "upcast": (True, True)}
# the (dtype, head width, contract) cases on the wgmma bodies; every other
# case keeps the mma.sync bodies
WGMMA_CASES = {(torch.bfloat16, 64, "no_max"), (torch.bfloat16, 64, "running_max")}
LAUNCHERS = {"flash_fwd": FLASH_FWD, "flash_bwd_dq": FLASH_BWD_DQ,
             "flash_bwd_dkv": FLASH_BWD_DKV, "flash_bwd_fused": FLASH_BWD_FUSED}


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_route(dtype, d, contract):
    upcast, _ = CONTRACTS[contract]
    want = ROUTE_WGMMA if (dtype, d, contract) in WGMMA_CASES else ROUTE_MMA
    assert attention_route(dtype, d, upcast) == want


@pytest.mark.parametrize("entry", sorted(LAUNCHERS))
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_launchers_pass_the_route(monkeypatch, entry, dtype, d, contract):
    """Each of the four launchers ends its C call with the route of
    `attention_route` for the inputs it launches on (under upcast the
    backward's inputs are f32, as `flash_attention_backward` casts them, and
    the forward casts bf16 itself; kernel 4 then its groups), with as many
    arguments as its C entry declares."""
    upcast, no_max = CONTRACTS[contract]
    launcher = LAUNCHERS[entry]
    calls = []
    monkeypatch.setattr(flash_module, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(flash_module, "_check_backward_rows", lambda *a: None)
    monkeypatch.setattr(launcher, "_launch", lambda device, *args: calls.append(args))
    bh, sq, sk = 2, 48, 40
    kernel_dtype = torch.float32 if upcast and entry != "flash_fwd" else dtype
    q, dout = (torch.zeros(bh, sq, d, dtype=kernel_dtype) for _ in range(2))
    k, v = (torch.zeros(bh, sk, d, dtype=kernel_dtype) for _ in range(2))
    if entry == "flash_fwd":
        launcher(q, k, v, scale=d**-0.5, upcast=upcast, no_max=no_max)
    else:
        rows = torch.zeros(bh, sq)
        launcher(q, k, v, dout, rows, rows, upcast=upcast, no_max=no_max, scale=d**-0.5)
    (args,) = calls
    want = ROUTE_WGMMA if (dtype, d, contract) in WGMMA_CASES else ROUTE_MMA
    if entry == "flash_bwd_fused":
        # kernel 4 then passes its groups of key blocks: FUSED_DQ_GROUPS dq
        # buffers on the wgmma route, one on the mma.sync route
        route, groups = args[-2:]
        assert groups == (FUSED_DQ_GROUPS if want == ROUTE_WGMMA else 1)
    else:
        route = args[-1]
    assert route == want
    # the C entry's own arguments (`_launch` adds the device and the stream)
    assert len(args) == len(launcher.argtypes)
