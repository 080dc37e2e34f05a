"""The port's conditioning blocks and the conditioned UNet against the JAX
ones, with carried-over weights.

Every JAX parameter is drawn from a numpy seed (`random_params`, none zero),
carried to the port by networks/convert.py, and both sides see the same
numpy inputs. f32 forwards compare at atol = rtol = 1e-5 for a block (sums
in another order), 1e-4 for a whole UNet or encoder (GroupNorm statistics
and conv sums reduced in another order through a dozen layers, as
tests/test_torch_unet.py). Attention runs on the plain path on both sides,
or JAX's flash kernel in interpret mode against the port's plain version.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.blocks import attention_blocks as jblocks
from generativemodels_tpu.networks.blocks.mlp import MLPBlock as JaxMLP
from generativemodels_tpu.networks.nets import (
    DiffusionModelEncoder as JaxEncoder,
    DiffusionModelUNet as JaxUNet,
)
from generativemodels_tpu_torch.networks import (
    diffusion_model_encoder_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.blocks import (
    BasicTransformerBlock,
    CrossAttention,
    MLPBlock,
    SpatialTransformer,
)
from generativemodels_tpu_torch.networks.nets import DiffusionModelEncoder, DiffusionModelUNet

from .test_torch_unet import random_params
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
BATCH = 2


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)).astype(np.float32)


def _block_pair(jmodule, port, *args, seed=0, **kwargs):
    """Init `jmodule` on numpy `args`, draw its params, load them into
    `port` (keys relative to the block, through the UNet translator)."""
    struct = zoo_convert.params_structure(jmodule, *(jnp.asarray(a) for a in args), **kwargs)
    params = random_params(struct, seed)
    port.load_state_dict(unet_state_dict_from_jax(params, port.state_dict()), strict=True)
    return params, port.eval()


@pytest.mark.parametrize("act", ["GELU", "GEGLU"])
def test_mlp_block_matches_jax(act):
    """flax's gelu is the tanh approximation: the port's must be too."""
    x = _rand(0, (BATCH, 10, 16), scale=2.0)
    jm = JaxMLP(hidden_size=16, mlp_dim=24, act=act)
    params, port = _block_pair(jm, MLPBlock(16, 24, act=act), x)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    with pytest.raises(ValueError):
        MLPBlock(16, 24, act="relu")


@pytest.mark.parametrize("upcast", [False, True], ids=["plain", "upcast"])
@pytest.mark.parametrize("with_context", [False, True], ids=["self", "cross"])
def test_cross_attention_matches_jax(with_context, upcast):
    x = _rand(1, (BATCH, 12, 32))
    ctx = _rand(2, (BATCH, 5, 6)) if with_context else None
    cfg = dict(query_dim=32, cross_attention_dim=6 if with_context else None,
               num_attention_heads=2, num_head_channels=8, upcast_attention=upcast)
    jm = jblocks.CrossAttention(**cfg)
    args = (x,) if ctx is None else (x, ctx)
    params, port = _block_pair(jm, CrossAttention(**cfg), *args)
    assert "to_out.0.weight" in port.state_dict() and "to_q.bias" not in port.state_dict()
    want = jm.apply({"params": params}, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_cross_attention_casts_the_context_in_bf16():
    """A float32 context into a bf16 block: cast by the projections, as
    flax's Dense(dtype=) casts its input; the output is bf16."""
    port = CrossAttention(16, cross_attention_dim=4, num_attention_heads=2, num_head_channels=8,
                          dtype=torch.bfloat16)
    out = port(torch.randn(1, 6, 16).to(torch.bfloat16), torch.randn(1, 1, 4))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


def test_basic_transformer_block_matches_jax():
    x, ctx = _rand(3, (BATCH, 9, 32)), _rand(4, (BATCH, 3, 8))
    cfg = dict(num_channels=32, num_attention_heads=4, num_head_channels=8,
               cross_attention_dim=8)
    jm = jblocks.BasicTransformerBlock(**cfg)
    params, port = _block_pair(jm, BasicTransformerBlock(**cfg), x, ctx)
    assert port.norm1.eps == 1e-6
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("spatial_dims", [2, 3])
def test_spatial_transformer_matches_jax(spatial_dims):
    """Channels-first in the port, channels-last in JAX; two layers; the
    JAX params draw a nonzero proj_out, so the transformer is in the sum."""
    spatial = (6, 5) if spatial_dims == 2 else (4, 3, 5)
    x = _rand(5, (BATCH, 16, *spatial))
    ctx = _rand(6, (BATCH, 2, 4))
    cfg = dict(spatial_dims=spatial_dims, in_channels=16, num_attention_heads=2,
               num_head_channels=8, num_layers=2, norm_num_groups=4, cross_attention_dim=4)
    jm = jblocks.SpatialTransformer(**cfg)
    x_last = np.moveaxis(x, 1, -1)
    params, port = _block_pair(jm, SpatialTransformer(**cfg), x_last, ctx)
    want = np.moveaxis(np.asarray(jm.apply({"params": params}, jnp.asarray(x_last),
                                           jnp.asarray(ctx))), -1, 1)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)
    fresh = SpatialTransformer(**cfg)
    assert not any(p.abs().sum() for p in fresh.proj_out.parameters())  # zero-initialised


COND = dict(
    spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
    num_channels=(16, 32, 32), attention_levels=(False, True, True),
    num_head_channels=(0, 16, 16), norm_num_groups=8, with_conditioning=True,
    cross_attention_dim=6,
)
SPATIAL = (8, 8)


def build_unet(seed=0, **overrides):
    """(jax model, numpy params, port model with the same weights)."""
    cfg = dict(COND, **overrides)
    jm = JaxUNet(**cfg)
    args = [jnp.zeros((BATCH, cfg["in_channels"], *SPATIAL)), jnp.zeros((BATCH,), jnp.int32)]
    kwargs = dict(context=jnp.zeros((BATCH, 3, cfg["cross_attention_dim"])))
    if cfg.get("num_class_embeds"):
        kwargs["class_labels"] = jnp.zeros((BATCH,), jnp.int32)
    params = random_params(zoo_convert.params_structure(jm, *args, **kwargs), seed)
    port = DiffusionModelUNet(**cfg)
    port.load_state_dict(unet_state_dict_from_jax(params, port.state_dict()), strict=True)
    return jm, params, port.eval()


def unet_inputs(seed=1, ctx_dim=6):
    x = _rand(seed, (BATCH, 1, *SPATIAL))
    ctx = _rand(seed + 1, (BATCH, 3, ctx_dim))
    return x, np.array([5, 800], dtype=np.int64), ctx


@pytest.mark.parametrize(
    "overrides",
    [dict(use_flash_attention=False),
     dict(use_flash_attention=True, upcast_attention=True),
     dict(use_flash_attention=False, transformer_num_layers=2, num_class_embeds=3)],
    ids=["plain", "flash_upcast", "two_layers_class"],
)
def test_conditioned_unet_matches_jax(overrides):
    """use_flash_attention=True: JAX's kernel in interpret mode under its
    upcast contract, the port's plain version of it."""
    jm, params, port = build_unet(**overrides)
    x, t, ctx = unet_inputs()
    kwargs, tkwargs = {}, {}
    if overrides.get("num_class_embeds"):
        labels = np.array([2, 0])
        kwargs["class_labels"] = jnp.asarray(labels)
        tkwargs["class_labels"] = torch.from_numpy(labels)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                    context=jnp.asarray(ctx), **kwargs)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), context=torch.from_numpy(ctx),
                   **tkwargs)
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)


def test_cached_down_gives_the_same_output():
    """`return_down` returns the down path's features; feeding them back as
    `cached_down` gives the same output, in the port as in JAX."""
    jm, params, port = build_unet(seed=2, use_flash_attention=False)
    x, t, ctx = unet_inputs(3)
    tx, tt, tctx = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)
    with torch.no_grad():
        out, cache = port(tx, tt, context=tctx, return_down=True)
        again = port(torch.zeros_like(tx), tt, context=tctx, cached_down=cache)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    j_out, j_cache = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                              context=jnp.asarray(ctx), return_down=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **NET_TOL)
    assert len(cache[1]) == len(j_cache[1])
    for a, b in zip(cache[1], j_cache[1]):  # the port's features are channels-first
        np.testing.assert_allclose(a.numpy(), np.moveaxis(np.asarray(b), -1, 1), **NET_TOL)


def test_conditioned_unet_round_trips_through_zoo_convert():
    """port.state_dict() through the JAX package's torch-checkpoint
    converter gives back exactly the JAX params (the transformer keys
    included), and the converted tensors own their storage."""
    jm, params, port = build_unet(seed=3, transformer_num_layers=2)
    struct = zoo_convert.params_structure(
        jm, jnp.zeros((BATCH, 1, *SPATIAL)), jnp.zeros((BATCH,), jnp.int32),
        context=jnp.zeros((BATCH, 3, 6)),
    )
    back = dict(jax.tree_util.tree_leaves_with_path(
        zoo_convert.convert_diffusion_model_unet(port.state_dict(), struct)))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(back)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf)
    sd = unet_state_dict_from_jax(params, port.state_dict())
    key = "down_blocks.1.attentions.0.transformer_blocks.1.norm2.weight"
    leaf = params["down_1"]["attn_0"]["block_1"]["norm2"]["scale"]
    before = leaf.copy()
    sd[key].add_(1.0)
    np.testing.assert_array_equal(leaf, before)


@pytest.mark.parametrize(
    "kwargs, message",
    [(dict(with_conditioning=True, cross_attention_dim=None), "cross_attention_dim"),
     (dict(with_conditioning=False, cross_attention_dim=6), "with_conditioning=True"),
     (dict(num_channels=(16, 30, 32)), "multiples of norm_num_groups"),
     (dict(attention_levels=(False, True), num_head_channels=16), "attention_levels"),
     (dict(num_head_channels=(0, 16)), "expected sequence of length 3"),
     (dict(num_res_blocks=(1, 1)), "expected sequence of length 3"),
     (dict(dropout_cattn=1.5), "Dropout")],
    ids=["no_dim", "no_conditioning", "groups", "levels", "heads", "res_blocks", "dropout"],
)
def test_unet_argument_errors_match_jax(kwargs, message):
    """The ValueErrors of `_validate_unet_args` (and the dropout check), as
    the JAX module raises them."""
    cfg = dict(COND, **kwargs)
    with pytest.raises(ValueError, match=message):
        DiffusionModelUNet(**cfg)
    with pytest.raises(ValueError, match=message):
        zoo_convert.params_structure(JaxUNet(**cfg), jnp.zeros((1, 1, *SPATIAL)),
                                     jnp.zeros((1,), jnp.int32))


def test_context_without_conditioning_raises():
    port = DiffusionModelUNet(**dict(COND, with_conditioning=False, cross_attention_dim=None))
    with pytest.raises(ValueError, match="with_conditioning"):
        port(torch.zeros(1, 1, *SPATIAL), torch.zeros(1, dtype=torch.long),
             context=torch.zeros(1, 1, 6))


@pytest.mark.parametrize("with_conditioning", [False, True], ids=["self", "cross"])
def test_diffusion_model_encoder_matches_jax(with_conditioning):
    """The head flattens channels-first in the port, channels-last in JAX:
    the converter permutes `out.0`'s columns (and zoo_convert back)."""
    cfg = dict(spatial_dims=2, in_channels=1, out_channels=3, num_res_blocks=1,
               num_channels=(16, 32), attention_levels=(False, True), num_head_channels=16,
               norm_num_groups=8, with_conditioning=with_conditioning,
               cross_attention_dim=6 if with_conditioning else None)
    x, t, ctx = unet_inputs(4)
    kw = dict(context=jnp.asarray(ctx)) if with_conditioning else {}
    jm = JaxEncoder(**cfg)
    params = random_params(zoo_convert.params_structure(
        jm, jnp.asarray(x), jnp.asarray(t, jnp.int32), **kw), 5)
    port = DiffusionModelEncoder(**cfg).eval()
    tkw = dict(context=torch.from_numpy(ctx)) if with_conditioning else {}
    with torch.no_grad():  # materialises out.0 at its input width
        port(torch.from_numpy(x), torch.from_numpy(t), **tkw)
    port.load_state_dict(diffusion_model_encoder_state_dict_from_jax(params, port.state_dict()))
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32), **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), **tkw)
    assert got.shape == (BATCH, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
    back = zoo_convert.convert_diffusion_model_encoder(port.state_dict(), params)
    np.testing.assert_array_equal(back["out_0"]["kernel"], params["out_0"]["kernel"])
