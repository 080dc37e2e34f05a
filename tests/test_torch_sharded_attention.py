"""Sequence-parallel attention of the port across real processes, held
against the JAX package's unsharded attention (tests/test_sharded_attention.py's
checks).

Two spawns (tests/test_torch_distributed.py::spawn): two ranks on a
{"space": 2} mesh, and four ranks on {"data": 2, "space": 2} and on
{"space": 4}; an axis of one rank on {"data": N, "space": 1}. Each rank
holds its rows (cut over "data" where the batch divides) and its block of
the sequence; its output and input gradients are held against the same
rows and block of the JAX function's, within 1e-5 (f32), the JAX tests'
bound. The gradients are those of sum(out^2) over the global output.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.ops import dot_product_attention as jax_attention
from generativemodels_tpu.ops.flash_attention import flash_attention_with_lse as jax_lse
from generativemodels_tpu_torch.ops import flash_attention_with_lse, sequence_sharding
from generativemodels_tpu_torch.ops.sharded_attention import (
    _chunk_attention_with_lse,
    _combine_chunks,
)
from generativemodels_tpu_torch.parallel import create_mesh

from .test_torch_distributed import spawn
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
HEADS = 2


def _qkv(b=4, s=32, inner=16, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, s, inner).astype(np.float32) for _ in range(3))


# name: (seed, batch, impl, layout, causal, grad)
SELF_CHECKS = {
    "allgather": (0, 4, "allgather", "blocked", False, False),
    "ring": (1, 4, "ring", "blocked", False, False),
    "odd_batch": (2, 3, "allgather", "blocked", False, False),
    "allgather_grads": (3, 4, "allgather", "blocked", False, True),
    "causal_allgather": (5, 4, "allgather", "blocked", True, False),
    "causal_ring": (6, 4, "ring", "blocked", True, False),
    "causal_allgather_grads": (7, 4, "allgather", "blocked", True, True),
    "causal_striped": (8, 4, "allgather", "striped", True, False),
    "causal_striped_grads": (9, 4, "allgather", "striped", True, True),
    "causal_ring_grads": (10, 4, "ring", "blocked", True, True),
    "noncausal_ignores_layout": (11, 4, "allgather", "striped", False, False),
    "ring_grads": (12, 4, "ring", "blocked", False, True),
}
MESHES = {2: [{"space": 2}, {"data": 2, "space": 1}],
          4: [{"data": 2, "space": 2}, {"space": 4}, {"data": 4, "space": 1}]}


def _checks(world: int) -> list[dict]:
    checks = []
    for m, shape in enumerate(MESHES[world]):
        if shape["space"] == 1:  # an axis of one rank falls back to the unsharded call
            q, k, v = _qkv(b=8, seed=4)
            checks.append(dict(name=f"axis_of_one/{m}", mesh=m, q=q, k=k, v=v, heads=HEADS,
                               impl="allgather", layout="blocked", causal=False, grad=False,
                               kind="self"))
            continue
        for name, (seed, b, impl, layout, causal, grad) in SELF_CHECKS.items():
            q, k, v = _qkv(b=b, seed=seed)
            checks.append(dict(name=f"{name}/{m}", mesh=m, q=q, k=k, v=v, heads=HEADS,
                               impl=impl, layout=layout, causal=causal, grad=grad,
                               kind="self"))
        # Sq != Sk (cross-attention) and masked calls are not rerouted
        rs = np.random.RandomState(5)
        q = rs.randn(4, 32, 16).astype(np.float32)
        k, v = (rs.randn(4, 5, 16).astype(np.float32) for _ in range(2))
        checks.append(dict(name=f"cross/{m}", mesh=m, q=q, k=k, v=v, heads=HEADS,
                           impl="allgather", layout="blocked", causal=False, grad=False,
                           kind="cross"))
        q, k, v = _qkv(seed=13)
        local = 32 // shape["space"]
        mask = np.random.RandomState(14).rand(local, local) > 0.3
        mask[np.arange(local), np.arange(local)] = True
        checks.append(dict(name=f"masked/{m}", mesh=m, q=q, k=k, v=v, heads=HEADS,
                           impl="allgather", layout="blocked", causal=False, grad=False,
                           kind="masked", mask=mask))
    return checks


def _reference(c: dict, rows: slice, block: slice):
    """The JAX output (and gradients) at this rank's rows and block."""
    q, k, v = map(jnp.asarray, (c["q"], c["k"], c["v"]))
    if c["kind"] == "masked":
        # not rerouted: the rank's own blocks, attended alone
        q, k, v = q[rows, block], k[rows, block], v[rows, block]
        out = jax_attention(q, k, v, HEADS, mask=jnp.asarray(c["mask"]))
        return {"out": np.asarray(out)}

    def f(q, k, v):
        return jax_attention(q, k, v, HEADS, causal=c["causal"])

    out = np.asarray(f(q, k, v))
    ref = {"out": out[rows, block]}
    if c["grad"]:
        grads = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) ** 2), argnums=(0, 1, 2))(q, k, v)
        for name, g in zip(("dq", "dk", "dv"), grads):
            ref[name] = np.asarray(g)[rows, block]
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def spawned(request, tmp_path_factory):
    world = request.param
    checks = _checks(world)
    outs = spawn("attention", world, dict(meshes=MESHES[world], checks=checks),
                 tmp_path_factory.mktemp(f"attention{world}"))
    return world, {c["name"]: c for c in checks}, outs


def _compare(spawned, prefix: str) -> int:
    world, checks, outs = spawned
    compared = 0
    for name, c in checks.items():
        if name.split("/")[0] != prefix:
            continue
        shape = MESHES[world][c["mesh"]]
        for o in outs:
            coords = o["coords"][c["mesh"]]
            d, i = shape.get("data", 1), coords.get("data", 0)
            n, r = shape["space"], coords["space"]
            b, s = c["q"].shape[:2]
            rows = slice(i * b // d, (i + 1) * b // d) if b % d == 0 else slice(None)
            block = slice(r * s // n, (r + 1) * s // n)
            ref = _reference(c, rows, block)
            for key, want in ref.items():
                np.testing.assert_allclose(o[name][key], want, atol=TOL, rtol=0,
                                           err_msg=f"{name} {key} rank {coords}")
            compared += 1
    return compared


@pytest.mark.parametrize("check", list(SELF_CHECKS))
def test_sequence_parallel_matches_unsharded(spawned, check):
    assert _compare(spawned, check) > 0


def test_one_rank_axis_falls_back(spawned):
    assert _compare(spawned, "axis_of_one") > 0


def test_cross_attention_and_masked_calls_not_rerouted(spawned):
    assert _compare(spawned, "cross") > 0
    assert _compare(spawned, "masked") > 0


def test_bad_layouts_raise():
    mesh = create_mesh({"space": 1}, device="cpu")
    with pytest.raises(ValueError, match="causal_layout"):
        with sequence_sharding(mesh, causal_layout="diagonal"):
            pass
    with pytest.raises(ValueError, match="impl"):
        with sequence_sharding(mesh, impl="tree"):
            pass
    with pytest.raises(ValueError, match="no axis"):
        with sequence_sharding(mesh, axis="depth"):
            pass


def test_striped_with_ring_raises():
    """The JAX module ignores the layout under the ring
    (sharded_attention.py:233); the port refuses it."""
    mesh = create_mesh({"space": 1}, device="cpu")
    with pytest.raises(ValueError, match="striped"):
        with sequence_sharding(mesh, impl="ring", causal_layout="striped"):
            pass


def test_four_chunk_logsumexp_combine_is_exact():
    """The ring's merge reproduces full softmax attention (the JAX test's
    plain chunks, atol 2e-5 as there)."""
    rs = np.random.RandomState(6)
    b, s, h, d = 2, 64, 2, 8
    q = rs.randn(b, s, h * d).astype(np.float32) * 3.0
    k = rs.randn(b, s, h * d).astype(np.float32) * 3.0
    v = rs.randn(b, s, h * d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v)), h, scale=scale))

    ks, vs = np.split(k, 4, axis=1), np.split(v, 4, axis=1)
    tq = torch.from_numpy(q)
    acc_out, acc_lse = _chunk_attention_with_lse(
        tq, torch.from_numpy(ks[0]), torch.from_numpy(vs[0]), h, scale, False, False)
    acc_out = acc_out.float()
    for i in range(1, 4):
        out_i, lse_i = _chunk_attention_with_lse(
            tq, torch.from_numpy(ks[i]), torch.from_numpy(vs[i]), h, scale, False, False)
        acc_out, acc_lse = _combine_chunks(acc_out, acc_lse, out_i, lse_i)
    np.testing.assert_allclose(acc_out.reshape(b, s, h * d).numpy(), ref, atol=2e-5)


def test_flash_chunk_lse_matches_jax_kernel():
    """The ring's building block, kernel 1 with its lse (its plain version
    on the CPU), against JAX's in interpret mode."""
    rs = np.random.RandomState(7)
    bh, s, d = 4, 128, 8
    q, k, v = (rs.randn(bh, s, d).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(d)
    out_j, lse_j = jax_lse(*map(jnp.asarray, (q, k, v)), scale=scale, block_q=64, block_k=64,
                           interpret=True)
    out_t, lse_t = flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), scale=scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=2e-5)
