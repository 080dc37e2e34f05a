"""The port's masked attention, SABlock, TransformerBlock and
DecoderOnlyTransformer against the JAX modules.

Every JAX parameter is drawn from a numpy seed and carried to the port by
`transformer_state_dict_from_jax`; both sides see the same numpy inputs.
Tolerances:
- f32 outputs (attention, blocks, logits, decode steps): 1e-5 of the
  largest output (float32 sums in another order);
- bf16 logits: within twice the JAX bf16 logits' own distance from the JAX
  f32 logits (both round to bf16 after every layer, at places of their own);
- the converter round trip through `zoo_convert.convert_transformer`: exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.blocks.selfattention import SABlock as JaxSABlock
from generativemodels_tpu.networks.blocks.selfattention import (
    TransformerBlock as JaxTransformerBlock,
)
from generativemodels_tpu.networks.nets import DecoderOnlyTransformer as JaxTransformer
from generativemodels_tpu.ops import dot_product_attention as jax_attention
from generativemodels_tpu_torch.networks import transformer_state_dict_from_jax
from generativemodels_tpu_torch.networks.blocks import SABlock, TransformerBlock
from generativemodels_tpu_torch.networks.nets import DecoderOnlyTransformer
from generativemodels_tpu_torch.ops import dot_product_attention, resolve_use_flash
from tests.test_torch_unet import random_params
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
BF16_RATIO = 2.0
B, S, C, HEADS = 2, 10, 16, 4
CFG = dict(num_tokens=17, max_seq_len=S, attn_layers_dim=C, attn_layers_depth=2,
           attn_layers_heads=HEADS)


def rand(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def tokens(seed: int = 0, n: int = S) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, CFG["num_tokens"], (B, n)).astype(np.int32)


def assert_close(got, want, rtol: float = RTOL) -> None:
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3  # the check is not empty
    assert float(np.abs(got - want).max()) <= rtol * scale


def load(port, params):
    port.load_state_dict(transformer_state_dict_from_jax(params, port.state_dict()), strict=True)
    return port


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mask_shape", [(B, 1, 7), (1, 5, 7), (B, 5, 7)],
                         ids=["keys", "queries", "full"])
def test_masked_attention_matches_jax(mask_shape, causal):
    q, k, v = rand((B, 5, C), 0), rand((B, 7, C), 1), rand((B, 7, C), 2)
    mask = np.random.RandomState(3).rand(*mask_shape) > 0.4
    mask[..., 0] = True  # every query row keeps a key
    want = jax_attention(*(jnp.asarray(t) for t in (q, k, v)), HEADS, causal=causal,
                         mask=jnp.asarray(mask), use_flash=False)
    got = dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)), HEADS,
                                causal=causal, mask=torch.from_numpy(mask))
    assert_close(got, want)


def test_masked_calls_take_the_plain_path():
    assert not resolve_use_flash(4096, 64, use_flash=True, on_cuda=True, has_mask=True)
    assert resolve_use_flash(4096, 64, on_cuda=True)
    assert not resolve_use_flash(4096, 64, on_cuda=True, has_mask=True)


def _sablock_pair(seed: int, **kw):
    jblock = JaxSABlock(hidden_size=C, num_heads=HEADS, **kw)
    x = jnp.zeros((B, S, C))
    params = random_params(zoo_convert.params_structure(jblock, x), seed)
    return jblock, params, load(SABlock(C, HEADS, **kw), params)


@pytest.mark.parametrize("mode", ["causal", "cross", "self_bias"])
def test_sablock_matches_jax(mode):
    kw = dict(causal=True, sequence_length=S) if mode == "causal" else (
        dict(with_cross_attention=True) if mode == "cross" else dict(qkv_bias=True))
    jblock, params, port = _sablock_pair(4, **kw)
    x, ctx = rand((B, S, C), 5), rand((B, 6, C), 6)
    context = ctx if mode == "cross" else None
    want = jblock.apply({"params": params}, jnp.asarray(x),
                        context=None if context is None else jnp.asarray(context))
    got = port(torch.from_numpy(x), None if context is None else torch.from_numpy(context))
    assert_close(got.detach(), want)


def test_sablock_decode_matches_jax():
    """Each decode step (one token written at the cache's index, the mask
    arange(S) <= index) equals JAX's, and the port's steps equal its own
    causal forward."""
    jblock, params, port = _sablock_pair(7, causal=True, sequence_length=S)
    x = rand((B, S, C), 8)
    jcache = jax.tree_util.tree_map(jnp.zeros_like, jblock.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 1, C)), decode=True)["cache"])
    cache = port.init_cache(B)
    full = port(torch.from_numpy(x)).detach()
    for i in range(S):
        want, mutated = jblock.apply({"params": params, "cache": jcache},
                                     jnp.asarray(x[:, i:i + 1]), decode=True, mutable=["cache"])
        jcache = mutated["cache"]
        with torch.no_grad():
            got, cache = port(torch.from_numpy(x[:, i:i + 1]), cache=cache)
        assert cache.index == i + 1
        assert_close(got, want)
        assert_close(got, full[:, i:i + 1])


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_transformer_block_matches_jax(cross):
    kw = dict(hidden_size=C, mlp_dim=4 * C, num_heads=HEADS, causal=True, sequence_length=S,
              with_cross_attention=cross)
    jblock = JaxTransformerBlock(**kw)
    x, ctx = rand((B, S, C), 9), rand((B, 6, C), 10)
    context = jnp.asarray(ctx) if cross else None
    params = random_params(zoo_convert.params_structure(jblock, jnp.asarray(x), context=context),
                           11)
    port = load(TransformerBlock(**kw), params)
    want = jblock.apply({"params": params}, jnp.asarray(x), context=context)
    got = port(torch.from_numpy(x), None if context is None else torch.from_numpy(ctx))
    assert_close(got.detach(), want)


def _transformer_pair(seed: int = 12, dtype=None, **overrides):
    cfg = dict(CFG, **overrides)
    jmodel = JaxTransformer(**cfg, dtype=None if dtype is None else jnp.bfloat16)
    params = random_params(zoo_convert.params_structure(
        JaxTransformer(**cfg), jnp.asarray(tokens())), seed)
    port = load(DecoderOnlyTransformer(**cfg, dtype=dtype), params)
    return jmodel, params, port


def test_transformer_logits_match_jax():
    jmodel, params, port = _transformer_pair()
    x = tokens(13)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x).long()).detach()
    assert got.dtype == torch.float32
    assert_close(got, want)


def test_transformer_bf16_matches_jax_within_its_own_rounding():
    j32, params, _ = _transformer_pair()
    j16, _, port = _transformer_pair(dtype=torch.bfloat16)
    x = jnp.asarray(tokens(14))
    want = np.asarray(j32.apply({"params": params}, x))
    jb = np.asarray(j16.apply({"params": params}, x))
    tb = port(torch.from_numpy(np.array(x)).long()).detach()
    assert tb.dtype == torch.float32 and jb.dtype == np.float32  # to_logits in f32
    own = float(np.abs(jb - want).max())
    assert own > 0  # bf16 rounding shows
    assert float(np.abs(tb.numpy() - jb).max()) <= BF16_RATIO * own


def test_decode_steps_match_the_full_forward_and_jax():
    """Decoding token by token (the position from the cache's counter)
    gives the full causal forward's logits, and JAX's decode steps'."""
    jmodel, params, port = _transformer_pair(seed=15)
    x = tokens(16)
    full = port(torch.from_numpy(x).long()).detach()
    jcache = jax.tree_util.tree_map(jnp.zeros_like, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 1), jnp.int32), decode=True)["cache"])
    cache = port.init_cache(B)
    for i in range(S):
        want, mutated = jmodel.apply({"params": params, "cache": jcache},
                                     jnp.asarray(x[:, i:i + 1]), decode=True, mutable=["cache"])
        jcache = mutated["cache"]
        with torch.no_grad():
            got, cache = port(torch.from_numpy(x[:, i:i + 1]).long(), cache=cache)
        assert cache.position == i + 1 and all(c.index == i + 1 for c in cache.blocks)
        assert_close(got, want)
        assert_close(got, full[:, i:i + 1])


def test_cross_attention_transformer_matches_jax():
    cfg = dict(CFG, with_cross_attention=True)
    jmodel = JaxTransformer(**cfg)
    x, ctx = jnp.asarray(tokens(17)), jnp.asarray(rand((B, 3, C), 18))
    params = random_params(zoo_convert.params_structure(jmodel, x, context=ctx), 19)
    port = load(DecoderOnlyTransformer(**cfg), params)
    want = jmodel.apply({"params": params}, x, context=ctx)
    got = port(torch.from_numpy(np.array(x)).long(), context=torch.from_numpy(np.array(ctx)))
    assert_close(got.detach(), want)


def test_state_dict_round_trips_through_zoo_convert():
    """port.state_dict() -> the JAX package's converter gives back exactly
    the JAX params the port was loaded from."""
    jmodel, params, port = _transformer_pair(seed=20)
    struct = zoo_convert.params_structure(jmodel, jnp.asarray(tokens()))
    back = zoo_convert.convert_transformer(port.state_dict(), struct)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)
    assert {"token_embeddings.weight", "position_embeddings.embedding.weight",
            "to_logits.weight", "blocks.1.attn.to_q.weight",
            "blocks.1.mlp.linear2.bias"} <= set(port.state_dict())


def test_converter_copies_and_checks():
    _, params, port = _transformer_pair(seed=21)
    sd = transformer_state_dict_from_jax(params, port.state_dict())
    sd["to_logits.bias"][0] = 99.0  # a copy: the JAX arrays keep their values
    assert params["to_logits"]["bias"][0] != 99.0
    bad = jax.tree_util.tree_map(lambda a: a, params)
    del bad["to_logits"]["bias"]
    with pytest.raises(KeyError):
        transformer_state_dict_from_jax(bad, port.state_dict())
