"""Which body kernels 1-4 run: `attention_route` over input type, head width
and contract, and the launchers that hand it to their C entries.

The forward, dq, dk/dv and fused launchers pass `attention_route(q.dtype,
D, upcast, kernel=...)`, each naming itself, to the C entries of
csrc/flash_fwd.cu and
csrc/flash_bwd.cu: bf16 at head width 64 in the two exp2 contracts takes
the wgmma bodies fed by a TMA ring (ROUTE_WGMMA), and so does bf16 at head
width 256 in kernels 2 and 3 (their D = 256 wgmma body), while kernels 1
and 4 keep mma.sync there; f32 at head width 64 in every contract (the
upcast contract's launchers run f32 inputs) takes the TF32 wgmma bodies in
kernels 2 and 3 (ROUTE_TF32) and the mma.sync bodies in kernels 1 and 4;
every other width keeps the mma.sync bodies (ROUTE_MMA).
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
    ROUTE_TF32,
    ROUTE_WGMMA,
)

# the module, which `ops` shadows with its function of the same name
flash_module = importlib.import_module("generativemodels_tpu_torch.ops.flash_attention")

# the contracts as the launchers take them: (upcast, no_max)
CONTRACTS = {"no_max": (False, True), "running_max": (False, False), "upcast": (True, True)}
# the (dtype, head width, contract) cases on the wgmma bodies; every other
# case keeps the mma.sync bodies, but for kernels 2 and 3 on f32 operands at
# head width 64 (TF32_CASES, and upcast whatever the input type)
WGMMA_CASES = {(torch.bfloat16, 64, "no_max"), (torch.bfloat16, 64, "running_max")}
TF32_CASES = {(torch.float32, 64, "no_max"), (torch.float32, 64, "running_max"),
              (torch.float32, 64, "upcast"), (torch.bfloat16, 64, "upcast")}
TF32_KERNELS = {"flash_bwd_dq", "flash_bwd_dkv"}
# the cases of kernels 2 and 3 (TF32_KERNELS) alone on their D = 256 wgmma body
WIDE_CASES = {(torch.bfloat16, 256, "no_max"), (torch.bfloat16, 256, "running_max")}
LAUNCHERS = {"flash_fwd": FLASH_FWD, "flash_bwd_dq": FLASH_BWD_DQ,
             "flash_bwd_dkv": FLASH_BWD_DKV, "flash_bwd_fused": FLASH_BWD_FUSED}


def expected_route(kernel, dtype, d, contract) -> int:
    if (dtype, d, contract) in WGMMA_CASES:
        return ROUTE_WGMMA
    if kernel in TF32_KERNELS and (dtype, d, contract) in WIDE_CASES:
        return ROUTE_WGMMA
    if kernel in TF32_KERNELS and (dtype, d, contract) in TF32_CASES:
        return ROUTE_TF32
    return ROUTE_MMA


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_route(dtype, d, contract):
    """Kernels 1 and 4 keep their two bodies: wgmma for bf16 at D = 64 in the
    exp2 contracts, mma.sync for every other input (f32 at D = 64 too)."""
    upcast, _ = CONTRACTS[contract]
    want = ROUTE_WGMMA if (dtype, d, contract) in WGMMA_CASES else ROUTE_MMA
    for kernel in ("flash_fwd", "flash_bwd_fused"):
        assert attention_route(dtype, d, upcast, kernel=kernel) == want


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("kernel", sorted(LAUNCHERS))
def test_wide_backward_route(kernel, contract):
    """At bf16 head width 256 (the 2D UNets' 256-wide heads: bench.py's
    training step, serving) kernels 2 and 3 take their D = 256 wgmma body
    in the two exp2 contracts; kernels 1 and 4 keep mma.sync there, and
    upcast (f32 operands, no body at D = 256 but mma.sync) keeps it in all
    four."""
    upcast, _ = CONTRACTS[contract]
    want = (ROUTE_WGMMA if kernel in TF32_KERNELS and not upcast else ROUTE_MMA)
    assert attention_route(torch.bfloat16, 256, upcast, kernel=kernel) == want
    assert attention_route(torch.float32, 256, upcast, kernel=kernel) == ROUTE_MMA


def test_route_of_an_unknown_kernel_raises():
    """A route names its kernel: an unknown one raises, and so does none."""
    with pytest.raises(ValueError, match="no flash kernel"):
        attention_route(torch.float32, 64, False, kernel="flash_bwd")
    with pytest.raises(TypeError):
        attention_route(torch.float32, 64, False)


@pytest.mark.parametrize("entry", sorted(LAUNCHERS))
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_launchers_pass_the_route(monkeypatch, entry, dtype, d, contract):
    """Each of the four launchers ends its C call with the route of
    `attention_route` for itself and the inputs it launches on (under
    upcast the backward's inputs are f32, as `flash_attention_backward`
    casts them, and the forward casts bf16 itself; kernel 4 then its
    groups), with as many arguments as its C entry declares: at f32 D = 64
    the TF32 route from kernels 2 and 3 alone."""
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
    want = expected_route(entry, dtype, d, contract)
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
