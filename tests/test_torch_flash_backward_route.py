"""Which body kernels 1-4 run: `attention_route` over input type, head width
and contract, and the launchers that hand it to their C entries.

The forward, dq, dk/dv and fused launchers pass `attention_route(q.dtype,
D, upcast, kernel=...)`, each naming itself, to the C entries of
csrc/flash_fwd.cu and
csrc/flash_bwd.cu: bf16 at head widths 64 and 256 in the two exp2
contracts takes the wgmma bodies fed by a TMA ring (ROUTE_WGMMA) in all
four kernels (their D = 256 wgmma bodies at 256); f32 in every contract
(the upcast contract's launchers run f32 inputs) takes the TF32 wgmma
bodies (ROUTE_TF32) at head widths 64, 128 and 256 in kernels 2 and 3, at
64 in kernel 4 and at 128 and 256 in kernel 1, and the mma.sync bodies in
kernel 4 at 128 and 256 and in kernel 1 at 32 and 64; every other case
keeps the mma.sync bodies (ROUTE_MMA).
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
# the (dtype, head width, contract) cases on the wgmma bodies of all four
# kernels (at D = 64, and at D = 256: WIDE_CASES); every other case keeps
# the mma.sync bodies, but for f32 operands (TF32_CASES, and upcast whatever
# the input type) at head widths 128 and 256 in kernels 1-3 and at 64 in
# kernels 2-4
WGMMA_CASES = {(torch.bfloat16, 64, "no_max"), (torch.bfloat16, 64, "running_max")}
TF32_CASES = {case for d in (64, 128, 256)
              for case in ((torch.float32, d, "no_max"), (torch.float32, d, "running_max"),
                           (torch.float32, d, "upcast"), (torch.bfloat16, d, "upcast"))}
TF32_KERNELS = {"flash_bwd_dq", "flash_bwd_dkv"}
# kernel 1's TF32 body is streamed over D: 128 and 256 (64 keeps mma.sync);
# kernel 4's is kernel 3's at 64 (128 and 256 keep mma.sync)
FWD_TF32_D = (128, 256)
FUSED_TF32_D = (64,)
# the cases of all four kernels on their D = 256 wgmma bodies
WIDE_CASES = {(torch.bfloat16, 256, "no_max"), (torch.bfloat16, 256, "running_max")}
LAUNCHERS = {"flash_fwd": FLASH_FWD, "flash_bwd_dq": FLASH_BWD_DQ,
             "flash_bwd_dkv": FLASH_BWD_DKV, "flash_bwd_fused": FLASH_BWD_FUSED}


def expected_route(kernel, dtype, d, contract) -> int:
    case = (dtype, d, contract)
    if case in WGMMA_CASES | WIDE_CASES:
        return ROUTE_WGMMA
    if kernel in TF32_KERNELS and case in TF32_CASES:
        return ROUTE_TF32
    if kernel == "flash_fwd" and case in TF32_CASES and d in FWD_TF32_D:
        return ROUTE_TF32
    if kernel == "flash_bwd_fused" and case in TF32_CASES and d in FUSED_TF32_D:
        return ROUTE_TF32
    return ROUTE_MMA


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_route(dtype, d, contract):
    """Kernel 4 has three bodies: wgmma for bf16 at D = 64 and 256 in the
    exp2 contracts, TF32 on f32 operands (f32 inputs, or upcast) at D = 64,
    mma.sync for every other input (f32 at D = 128 and 256 too). Kernel 1
    has three: wgmma for bf16 at D = 64 and 256 in the exp2 contracts, TF32
    on f32 operands at D = 128 and 256, mma.sync for the rest (D = 32, bf16
    D = 128, f32 D = 64)."""
    upcast, _ = CONTRACTS[contract]
    case = (dtype, d, contract)
    want = (ROUTE_WGMMA if case in WGMMA_CASES | WIDE_CASES
            else ROUTE_TF32 if case in TF32_CASES and d in FUSED_TF32_D else ROUTE_MMA)
    assert attention_route(dtype, d, upcast, kernel="flash_bwd_fused") == want
    want = (ROUTE_WGMMA if case in WGMMA_CASES | WIDE_CASES
            else ROUTE_TF32 if case in TF32_CASES and d in FWD_TF32_D else ROUTE_MMA)
    assert attention_route(dtype, d, upcast, kernel="flash_fwd") == want


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("kernel", sorted(LAUNCHERS))
def test_wide_backward_route(kernel, contract):
    """At bf16 head width 256 (the 2D UNets' 256-wide heads: bench.py's
    training step, serving) all four kernels take their D = 256 wgmma
    bodies in the two exp2 contracts; on f32 operands (f32 inputs, or
    upcast) kernels 1-3 take their TF32 bodies there, in all three
    contracts, and kernel 4 keeps mma.sync."""
    upcast, _ = CONTRACTS[contract]
    tf32 = kernel != "flash_bwd_fused"
    f32_route = ROUTE_TF32 if tf32 else ROUTE_MMA
    want = f32_route if upcast else ROUTE_WGMMA
    assert attention_route(torch.bfloat16, 256, upcast, kernel=kernel) == want
    assert attention_route(torch.float32, 256, upcast, kernel=kernel) == f32_route


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
    the TF32 route from kernels 2-4, at 128 and 256 from kernels 1-3."""
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
        # kernel 4 then passes its groups of key blocks: FUSED_DQ_GROUPS of
        # the head width dq buffers on the wgmma and TF32 routes, one on
        # the mma.sync route
        route, groups = args[-2:]
        assert groups == (FUSED_DQ_GROUPS[d] if want != ROUTE_MMA else 1)
    else:
        route = args[-1]
    assert route == want
    # the C entry's own arguments (`_launch` adds the device and the stream)
    assert len(args) == len(launcher.argtypes)
