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
from generativemodels_tpu_torch.ops.fused_conv import CONV_RUNS
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


# the bf16, head width 64 cases that the fused kernel runs on its wgmma body
# on the card: (numpy seed, BH, Sq, Sk, D, causal, q multiplier), a causal
# square and a causal one whose rows and keys are no multiple of 128
BF16_MASKED_CASES = {
    "causal": (11, 2, 256, 256, 64, True, 1.0),
    "ragged_causal": (12, 2, 320, 320, 64, True, 1.0),
}


@pytest.mark.parametrize("name", sorted(BF16_MASKED_CASES))
def test_fused_backward_matches_jax_bf16_masked(name, monkeypatch):
    """As test_fused_backward_matches_jax_bf16, under the causal mask."""
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    seed, bh, sq, sk, d, causal, mult = BF16_MASKED_CASES[name]
    q, k, v = _inputs(seed, bh, sq, sk, d, mult)
    want = _jax_grads(q, k, v, causal=causal, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, causal=causal, dtype=torch.bfloat16)
    for w, x, label in zip(want, got, ("dq", "dk", "dv")):
        assert np.abs(w).max() > 1e-3, label  # the check is not empty
        assert np.abs(x - w).max() <= BF16_REL * np.abs(w).max(), label


# the bf16, head width 256 cases that the fused kernel runs on its D = 256
# wgmma body on the card (64-key blocks, 64-row q tiles): (numpy seed, BH,
# Sq, Sk, D, causal, q multiplier), two kv tiles of the JAX kernel, a causal
# square whose rows are no multiple of 128, and a padded last kv tile
BF16_WIDE_CASES = {
    "plain": (11, 2, 128, 256, 256, False, 1.0),
    "causal": (11, 2, 192, 192, 256, True, 1.0),
    "ragged_kv": (12, 2, 128, 200, 256, False, 1.0),
}


@pytest.mark.parametrize("name", sorted(BF16_WIDE_CASES))
def test_fused_backward_matches_jax_bf16_wide(name, monkeypatch):
    """As test_fused_backward_matches_jax_bf16, at head width 256."""
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", "1")
    seed, bh, sq, sk, d, causal, mult = BF16_WIDE_CASES[name]
    q, k, v = _inputs(seed, bh, sq, sk, d, mult)
    want = _jax_grads(q, k, v, causal=causal, dtype=jnp.bfloat16)
    got = _port_grads(q, k, v, causal=causal, dtype=torch.bfloat16)
    for w, x, label in zip(want, got, ("dq", "dk", "dv")):
        assert np.abs(w).max() > 1e-3, label  # the check is not empty
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
    csrc/flash_bwd.cu declares, chosen as the kernel chooses them (the wgmma
    body's 64-row q tiles and 128-key blocks at bf16 D = 64, the D = 256
    wgmma body's 64-row q tiles and 64-key blocks at bf16 D = 256, the TF32
    body's 32-row q tiles and 128-key blocks at f32 D = 64, the mma.sync
    body's otherwise); the launcher's kernel-4 counters (one per _BLOCK rows
    a head) cover every q tile the kernel counts (a lock too small means
    counters out of bounds or a wait that never ends); chip_smoke's count of
    ordered dq adds follows the kernel's loops; and its kernel-1 block
    heights are csrc/flash_fwd.cu's (64- or 128-row blocks on the wgmma
    routes, bf16 at D = 64 and 256, by whether 128-row ones leave half of
    the card's SMs idle; on the TF32 route, f32 at D = 128 and 256, 64-row
    blocks in clusters of two that split the keys where one block a row
    block leaves half of them idle)."""
    text = (REPO / "generativemodels_tpu_torch" / "csrc" / "flash_bwd.cu").read_text()

    def constants(text):
        found = {}
        for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", text):
            found.setdefault(name, int(value))
        return found

    def namespace(name):  # the first block of `namespace name`
        start = text.index(f"namespace {name} {{")
        return constants(text[start:text.index(f"}}  // namespace {name}", start)])

    tiles, wg, wd, tf = constants(text), namespace("wg"), namespace("wd"), namespace("tf")
    assert "kBr = kBf16 ? kBrBf16 : kBrF32;" in text
    assert "kBc = D <= kNarrowD ? kBcNarrow : kBcWide;" in text
    assert "constexpr int kBlockRows = kConsumers * kRows;" in text
    assert "constexpr int kDkvKeys = kRows;" in text
    # the Hopper bodies' counters: ceil(sq / q tile) a head in each group
    for tile in ("wg::kTile", "wd::kDkvTile", "tf::kTile"):
        assert f"const int q_tiles = (sq + {tile} - 1) / {tile};" in text
    assert text.count("dq_lock + static_cast<size_t>(gbh) * q_tiles") == 3
    if dtype == "bfloat16" and d == wg["kD"]:
        rows, keys = wg["kTile"], wg["kConsumers"] * wg["kRows"]
        assert (rows, keys) == (64, 128)
    elif dtype == "bfloat16" and d == wd["kD"]:
        rows, keys = wd["kDkvTile"], wd["kRows"]
        assert (rows, keys) == (64, 64)
    elif dtype == "float32" and d == tf["kD"]:
        rows, keys = tf["kTile"], tf["kConsumers"] * tf["kRows"]
        assert (rows, keys) == (32, 128)
    else:
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
    fwd = (REPO / "generativemodels_tpu_torch" / "csrc" / "flash_fwd.cu").read_text()
    assert "constexpr int kRows = 64;" in fwd
    assert ("return 2 * blocks <= sms ? launch_wgmma_blocks<D, K, 1>(a, device)\n"
            "                           : launch_wgmma_blocks<D, K, 2>(a, device);") in fwd
    assert "static constexpr int kM = D <= 64 ? 2 : 1;" in fwd
    assert "constexpr int kSplits = 2;" in fwd
    assert "const int splits = 2 * blocks <= sms ? ts::kSplits : 1;" in fwd
    sms = 132
    for bh, sq in ((2, 4096), (2, 8192), (2, 32768), (3, 257), (66, 128), (67, 128),
                   (4, 1024), (16, 1024), (66, 64), (67, 64)):
        blocks_128 = bh * -(-sq // 128)
        if dtype == "bfloat16" and d in (64, 256):
            want = 64 if 2 * blocks_128 <= sms else 128, 1
        elif dtype == "float32" and d in (128, 256):
            want = 64, 2 if 2 * bh * -(-sq // 64) <= sms else 1
        else:
            want = 32 if dtype == "float32" else 128 if d <= 64 else 64, 1
        assert smoke.forward_block_rows(bh, sq, d, dtype, sms) == want


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


_CONV_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121fused_conv_f32_kernelILi128EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121fused_conv_f32_kernelILi128EEEvPKfS2_
    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 43392 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121fused_conv_mma_kernelILi4EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121fused_conv_mma_kernelILi4EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


_FLASH_PTXAS_ENTRY = ("ptxas info    : Compiling entry function "
                      "'_ZN45_GLOBAL__N__0eb68e6c_12_flash_fwd_cu_a0ddee6c{name}' for 'sm_90a'\n"
                      "ptxas info    : Function properties for x\n"
                      "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                      "ptxas info    : Used 168 registers\n")


@pytest.mark.parametrize("extra", [None, "21flash_fwd_bf16_kernelILi64ELi0EEEvPK13__nv_bfloat16"],
                         ids=["as_built", "mma_at_bf16_d64"])
def test_phase1_counts_each_flash_kernel(extra):
    """Phase 1 reads kernel 1's instantiations kernel by kernel: the
    mma.sync bf16 body at D 32 and 128 in the two exp2 contracts, the f32
    one at D 32 and 64 in three, the wgmma bodies at D = 64 and 256 in two
    contracts at two block heights, the TF32 body at D = 128 and 256 in
    three; an mma.sync bf16 instance at D = 64 (which the wgmma body
    replaces) changes the counts. The counts of both flash sources add up
    to NO_STACK_INSTANCES."""
    smoke = _chip_smoke()
    names = ([f"21flash_fwd_bf16_kernelILi{d}ELi{c}EEEvPK13__nv_bfloat16"
              for d in (32, 128) for c in (0, 1)]
             + [f"20flash_fwd_f32_kernelILi{d}ELi{c}EEEvPKfS2_" for d in (32, 64)
                for c in (0, 1, 2)]
             + [f"22flash_fwd_wgmma_kernelILi{c}ELi{n}EEEv14CUtensorMap_st" for c in (0, 1)
                for n in (1, 2)]
             + [f"21flash_fwd_wide_kernelILi{c}ELi{n}EEEv14CUtensorMap_st" for c in (0, 1)
                for n in (1, 2)]
             + [f"23flash_fwd_stream_kernelILi{a}ELi{c}EEEv14CUtensorMap_st" for a in (4, 8)
                for c in (0, 1, 2)])
    if extra:
        names.append(extra)
    entries = smoke.ptxas_entries("".join(_FLASH_PTXAS_ENTRY.format(name=n) for n in names))
    want = smoke.KERNEL_INSTANCES["flash_fwd.cu"]
    counts = smoke.kernel_instances(entries, want)
    assert (counts == want) == (extra is None)
    assert smoke.stack_offenders(entries) == ([], len(names))
    for source in ("flash_fwd.cu", "flash_bwd.cu"):
        assert sum(smoke.KERNEL_INSTANCES[source].values()) == smoke.NO_STACK_INSTANCES[source]


@pytest.mark.parametrize("stack, stores, loads", [(0, 0, 0), (24, 24, 24)],
                         ids=["clean", "spills"])
def test_ptxas_entries_hold_kernel5_to_no_stack(stack, stores, loads):
    """Kernel 5's f32 and bf16 instantiations are held to the same rule as
    kernels 2-4, and chip_smoke counts how many of fused_conv.cu's it read."""
    smoke = _chip_smoke()
    entries = smoke.ptxas_entries(_CONV_PTXAS_LOG.format(stack=stack, stores=stores,
                                                         loads=loads))
    assert [e["registers"] for e in entries] == [128, 168]
    assert entries[0]["stack"] == stack and entries[0]["spill_loads"] == loads
    offenders, checked = smoke.stack_offenders(entries)
    assert offenders == ([entries[0]["name"]] if stack else [])
    assert checked == (1 if stack else 2)
    assert smoke.NO_STACK_INSTANCES["fused_conv.cu"] == 3 + len(CONV_RUNS)
