"""The port's backward under GMTPU_FLASH_FUSED_BWD=1 against `jax.grad` of
the JAX kernel with its fused backward.

The JAX side differentiates `flash_attention(..., interpret=True,
block_q=128, block_k=128)` with the variable set by `monkeypatch.setenv`,
so its custom VJP runs the Pallas kernel `_dfused_kernel` in interpret
mode: dq as per-kv-tile partial slabs summed outside the kernel. The port's
CPU gradients run with the same setting; on CPU tensors the plain backward
`flash_attention_backward_reference` serves it, because the fused kernel
computes the same function as the split ones (on the card, kernel 4 is held
against it by tests/test_torch_kernels_gpu.py and chip_smoke.py). The
inputs are those of tests/test_ops.py's TestFlashFusedBackward (seeds 11
and 12: several kv tiles, causal, ragged kv) and a clamp case (q x 100,
natural logits far past the no-max clamp), with the loss sum(out**2) on both
sides. f32 compares at rtol 1e-5 and atol 1e-5 x max(1, max|grad|), as
tests/test_torch_flash_backward.py does (summation order only); bf16 at
2e-2 of the largest gradient (p, ds and the outputs rounded to bf16).
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.ops.flash_attention import flash_attention as jflash
from generativemodels_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_BWD_FUSED,
    FLASH_FWD,
    flash_attention,
)
from generativemodels_tpu_torch.ops.flash_attention import _BLOCK

REPO = Path(__file__).resolve().parent.parent

F32_TOL = 1e-5
BF16_REL = 2e-2
SCALE = 1 / 8.0

# name: (numpy seed, BH, Sq, Sk, D, causal, q multiplier)
CASES = {
    "multi_ktile": (11, 2, 256, 512, 64, False, 1.0),  # 4 kv tiles of 128, 2 q tiles
    "causal": (11, 2, 256, 256, 64, True, 1.0),
    "ragged_kv": (12, 2, 256, 320, 64, False, 1.0),  # a padded last kv tile
    "clamp": (11, 2, 256, 512, 64, False, 100.0),
}


def _inputs(seed, bh, sq, sk, d, mult):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, sk, d)).astype(np.float32)
    v = rng.standard_normal((bh, sk, d)).astype(np.float32)
    return q * np.float32(mult), k, v


def _jax_grads(q, k, v, *, causal, dtype=jnp.float32):
    def f(q, k, v):
        out = jflash(q, k, v, scale=SCALE, causal=causal, interpret=True,
                     block_q=128, block_k=128)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    args = [jnp.asarray(a, dtype=dtype) for a in (q, k, v)]
    return [np.asarray(x, dtype=np.float32) for x in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _port_grads(q, k, v, *, causal, dtype=torch.float32):
    qkv = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*qkv, scale=SCALE, causal=causal)
    (out.float() ** 2).sum().backward()
    return [t.grad.float().numpy() for t in qkv]


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_backward_matches_jax(name, monkeypatch):
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    seed, bh, sq, sk, d, causal, mult = CASES[name]
    q, k, v = _inputs(seed, bh, sq, sk, d, mult)
    want = _jax_grads(q, k, v, causal=causal)
    got = _port_grads(q, k, v, causal=causal)
    for w, x, label in zip(want, got, ("dq", "dk", "dv")):
        scale_of_w = np.abs(w).max()
        assert scale_of_w > 1e-3, label  # the check is not empty
        np.testing.assert_allclose(
            x, w, rtol=F32_TOL, atol=F32_TOL * max(1.0, scale_of_w), err_msg=label
        )


def test_fused_backward_matches_jax_bf16(monkeypatch):
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    q, k, v = _inputs(12, 2, 256, 320, 64, 1.0)
    want = _jax_grads(q, k, v, causal=False, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, causal=False, dtype=torch.bfloat16)
    for w, x, label in zip(want, got, ("dq", "dk", "dv")):
        assert np.abs(x - w).max() <= BF16_REL * np.abs(w).max(), label


def test_fused_switch_launches_no_kernel_on_cpu(monkeypatch):
    """On CPU tensors the switch changes nothing: the plain backward, no launch."""
    q, k, v = _inputs(2, 2, 96, 80, 32, 1.0)
    counters = (FLASH_FWD, FLASH_BWD_DQ, FLASH_BWD_DKV, FLASH_BWD_FUSED)
    before = [c.launches for c in counters]
    split = _port_grads(q, k, v, causal=False)
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    fused = _port_grads(q, k, v, causal=False)
    assert [c.launches for c in counters] == before
    for a, b in zip(split, fused):
        assert np.isfinite(b).all()
        np.testing.assert_array_equal(a, b)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_launcher_tiles_follow_the_kernel_source(dtype, d):
    """chip_smoke's tiles of kernels 3 and 4 are the `constexpr`s that
    csrc/flash_bwd.cu declares, chosen as the kernel chooses them; the
    launcher's kernel-4 counters (one per _BLOCK rows a head) cover every
    q tile the kernel counts (a lock too small means counters out of bounds
    or a wait that never ends); and chip_smoke's count of ordered dq adds
    follows the kernel's loops."""
    text = (REPO / "generativemodels_tpu_torch" / "csrc" / "flash_bwd.cu").read_text()
    tiles = {name: int(value) for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert "kBr = kBf16 ? kBrBf16 : kBrF32;" in text
    assert "kBc = D <= kNarrowD ? kBcNarrow : kBcWide;" in text
    rows = tiles["kBrBf16"] if dtype == "bfloat16" else tiles["kBrF32"]
    keys = tiles["kBcNarrow"] if d <= tiles["kNarrowD"] else tiles["kBcWide"]
    smoke = _chip_smoke()
    assert smoke.dkv_tiles(dtype, d) == (rows, keys)
    bh, sq, sk = 3, 257, 300  # no multiples of either tile
    assert -(-sq // _BLOCK) >= -(-sq // rows)
    for causal in (False, True):
        # each key block walks the q tiles from row 0, or under the causal
        # mask from its own first key, adding D / 2 float2 to each live row
        adds = 0
        for k0 in range(0, sk, keys):
            for q0 in range(k0 if causal else 0, sq, rows):
                adds += bh * min(rows, sq - q0) * d // 2
        assert smoke.fused_dq_adds(bh, sq, sk, d, dtype, causal) == adds


_PTXAS_LOG = """ptxas info    : Compiling entry function '_Z20flash_bwd_dkv_kernelIfLi64EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z20flash_bwd_dkv_kernelIfLi64EEvPKT_
    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_Z19flash_bwd_dq_kernelIfLi64EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z19flash_bwd_dq_kernelIfLi64EEvPKT_
    {dq_stack} bytes stack frame, {dq_stores} bytes spill stores, {dq_loads} bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z22flash_bwd_roles_kernelIfLi64EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z22flash_bwd_roles_kernelIfLi64EEvPKT_
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize(
    "stack, stores, loads, dq",
    [(0, 0, 0, (24, 16, 36)), (8, 4, 12, (24, 16, 36)), (0, 0, 0, (0, 0, 0))],
    ids=["clean", "spills", "dq_clean"],
)
def test_ptxas_entries_reads_stack_and_spills(stack, stores, loads, dq):
    """Phase 1's reading of the ptxas log, which fails a build of kernels 2,
    3 and 4 with a stack frame or spills: every entry function with its
    registers, stack frame and spill bytes, and the offenders among kernels
    2-4 (the test entry of their s, dp computation is not one of them)."""
    log = _PTXAS_LOG.format(stack=stack, stores=stores, loads=loads, dq_stack=dq[0],
                            dq_stores=dq[1], dq_loads=dq[2])
    smoke = _chip_smoke()
    entries = smoke.ptxas_entries(log)
    assert entries == [
        dict(name="_Z20flash_bwd_dkv_kernelIfLi64EEvPKT_", registers=168, stack=stack,
             spill_stores=stores, spill_loads=loads),
        dict(name="_Z19flash_bwd_dq_kernelIfLi64EEvPKT_", registers=80, stack=dq[0],
             spill_stores=dq[1], spill_loads=dq[2]),
        dict(name="_Z22flash_bwd_roles_kernelIfLi64EEvPKT_", registers=64, stack=8,
             spill_stores=0, spill_loads=0),
    ]
    offenders, checked = smoke.stack_offenders(entries)
    want = [e["name"] for e in entries[:2] if e["stack"] + e["spill_stores"] + e["spill_loads"]]
    assert offenders == want and checked == 2 - len(want)
