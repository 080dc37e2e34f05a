"""The port's SPADE modules against the JAX package: the SPADE norm (GROUP
affine and parameter-free, INSTANCE), SpatialRescaler (each method, by
`size` and by `multiplier`), SPADEAutoencoderKL, SPADEDiffusionModelUNet,
SPADENet and the three converters.

Every JAX parameter is drawn from a numpy seed and carried to the port by
the converters; both sides see the same numpy inputs (channels-first in the
port, channels-last inside the JAX modules). Tolerances: f32 outputs within
1e-5 of the largest output (RTOL; float32 sums in another order), 1e-4 for
the deeper networks (NET_RTOL: each SPADE instance-normalises a conv of a
conv, which scales its input's rounding by 1/std); the converter round
trips through `zoo_convert.convert_spade_*` exact.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.blocks.encoder_modules import (
    SpatialRescaler as JaxRescaler,
)
from generativemodels_tpu.networks.blocks.spade_norm import SPADE as JaxSPADE
from generativemodels_tpu.networks.nets import SPADEAutoencoderKL as JaxSPADEAEKL
from generativemodels_tpu.networks.nets import SPADEDiffusionModelUNet as JaxSPADEUNet
from generativemodels_tpu.networks.nets import SPADENet as JaxSPADENet
from generativemodels_tpu_torch.networks import (
    spade_autoencoderkl_state_dict_from_jax,
    spade_diffusion_model_unet_state_dict_from_jax,
    spade_network_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.blocks import SPADE, SpatialRescaler
from generativemodels_tpu_torch.networks.blocks.spade_norm import resize_nearest
from generativemodels_tpu_torch.networks.nets import (
    SPADEAutoencoderKL,
    SPADEDiffusionModelUNet,
    SPADENet,
)
from generativemodels_tpu_torch.networks.nets.spade_network import kld_loss
from tests.test_torch_unet import random_params
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
NET_RTOL = 1e-4
B, LABEL_NC = 2, 3


def rand(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def segmap(shape, seed: int) -> np.ndarray:
    """A one-hot (B, LABEL_NC, *spatial) map."""
    labels = np.random.RandomState(seed).randint(0, LABEL_NC, (shape[0],) + tuple(shape[2:]))
    return np.moveaxis(np.eye(LABEL_NC, dtype=np.float32)[labels], -1, 1).copy()


def cl(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.moveaxis(x, 1, -1))


def cf(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -1, 1)


def assert_close(got, want, rtol: float = RTOL) -> None:
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3  # the check is not empty
    assert float(np.abs(got - want).max()) <= rtol * scale


def assert_round_trip(params, back) -> None:
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)


SPADE_NORMS = {
    "group_affine": dict(norm="GROUP", norm_params={"num_groups": 4, "eps": 1e-6,
                                                    "affine": True}),
    "group_plain": dict(norm="GROUP", norm_params={"num_groups": 4, "affine": False}),
    "instance": dict(norm="INSTANCE"),
}


@pytest.mark.parametrize("seg_size", [8, 12, 5], ids=["same", "down_uneven", "up"])
@pytest.mark.parametrize("norm", list(SPADE_NORMS))
def test_spade_norm_matches_jax(norm, seg_size):
    kw = dict(label_nc=LABEL_NC, norm_nc=8, hidden_channels=6, **SPADE_NORMS[norm])
    jblock = JaxSPADE(**kw)
    x, seg = rand((B, 8, 8, 8), 0), segmap((B, LABEL_NC, seg_size, seg_size), 1)
    params = random_params(zoo_convert.params_structure(jblock, cl(x), cl(seg)), 2)
    port = SPADE(**kw)
    port.load_state_dict(spade_diffusion_model_unet_state_dict_from_jax(
        params, port.state_dict()), strict=True)
    assert ("param_free_norm.N.weight" in port.state_dict()) == (norm == "group_affine")
    want = jblock.apply({"params": params}, cl(x), cl(seg))
    got = port(torch.from_numpy(x), torch.from_numpy(seg)).detach()
    assert_close(got, cf(want))


def test_resize_nearest_is_torchs_floor_rule():
    x = torch.arange(2 * 12 * 7, dtype=torch.float32).reshape(1, 2, 12, 7)
    for shape in ((5, 3), (8, 7), (24, 10)):
        torch.testing.assert_close(resize_nearest(x, shape),
                                   torch.nn.functional.interpolate(x, size=shape, mode="nearest"))


RESCALES = {
    "nearest_size": dict(method="nearest", size=(7, 5)),
    "bilinear_size": dict(method="bilinear", size=(13, 6)),
    "bicubic_size": dict(method="bicubic", size=(11, 17)),
    "area_size": dict(method="area", size=(4, 3)),
    "nearest_mult": dict(method="nearest", multiplier=0.7),
    "bilinear_mult": dict(method="bilinear", multiplier=(1.5, 0.6)),
    "bicubic_mult": dict(method="bicubic", multiplier=1.3),
    "area_mult": dict(method="area", multiplier=0.5),
    "two_stages_mapped": dict(method="bilinear", multiplier=0.75, n_stages=2, out_channels=4),
}


@pytest.mark.parametrize("case", list(RESCALES))
def test_spatial_rescaler_matches_jax(case):
    kw = dict(spatial_dims=2, in_channels=3, **RESCALES[case])
    x = rand((B, 3, 9, 10), 3)
    jmodel = JaxRescaler(**kw)
    if kw.get("out_channels"):
        params = random_params(zoo_convert.params_structure(jmodel, jnp.asarray(x)), 4)
    else:
        params = {}
    port = SpatialRescaler(**kw)
    port.load_state_dict(spade_diffusion_model_unet_state_dict_from_jax(
        params, port.state_dict()), strict=True)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    got = port(torch.from_numpy(x)).detach()
    assert_close(got, want)


def test_spatial_rescaler_trilinear_3d_matches_jax():
    kw = dict(spatial_dims=3, in_channels=2, method="trilinear", multiplier=1.5)
    x = rand((1, 2, 4, 5, 3), 5)
    want = JaxRescaler(**kw).apply({"params": {}}, jnp.asarray(x))
    assert_close(SpatialRescaler(**kw)(torch.from_numpy(x)), want)


AEKL = dict(spatial_dims=2, label_nc=LABEL_NC, in_channels=1, out_channels=1,
            num_res_blocks=1, num_channels=(8, 16), attention_levels=(False, True),
            latent_channels=3, norm_num_groups=4, spade_intermediate_channels=8)


def _aekl_pair(seed: int = 6, **overrides):
    cfg = dict(AEKL, **overrides)
    jmodel = JaxSPADEAEKL(**cfg)
    x, seg = jnp.zeros((B, 1, 16, 16)), jnp.zeros((B, LABEL_NC, 16, 16))
    struct = zoo_convert.params_structure(jmodel, x, seg, method=JaxSPADEAEKL.reconstruct)
    params = random_params(struct, seed)
    port = SPADEAutoencoderKL(**cfg)
    port.load_state_dict(spade_autoencoderkl_state_dict_from_jax(
        params, port.state_dict(), cfg["num_channels"], cfg["num_res_blocks"],
        cfg["attention_levels"]), strict=True)
    return jmodel, params, port.eval(), struct, cfg


def test_spade_autoencoderkl_matches_jax():
    jmodel, params, port, _, _ = _aekl_pair()
    x, seg = rand((B, 1, 16, 16), 7), segmap((B, LABEL_NC, 16, 16), 8)
    z = rand((B, 3, 8, 8), 9)
    with torch.no_grad():
        for method, args in (("encode", (x,)), ("decode", (z, seg)), ("reconstruct", (x, seg))):
            want = jax.tree_util.tree_leaves(jmodel.apply(
                {"params": params}, *(jnp.asarray(a) for a in args),
                method=getattr(JaxSPADEAEKL, method)))
            got = getattr(port, method)(*(torch.from_numpy(a) for a in args))
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, want):
                assert_close(g, w, NET_RTOL)
    assert port.label_nc == LABEL_NC


def test_spade_autoencoderkl_round_trips_through_zoo_convert():
    _, params, port, struct, cfg = _aekl_pair(seed=10)
    back = zoo_convert.convert_spade_autoencoderkl(
        port.state_dict(), struct, cfg["num_channels"], cfg["num_res_blocks"],
        cfg["attention_levels"])
    assert_round_trip(params, back)


UNET = dict(spatial_dims=2, in_channels=3, out_channels=3, label_nc=LABEL_NC,
            num_res_blocks=1, num_channels=(8, 16), attention_levels=(False, True),
            norm_num_groups=4, num_head_channels=8, spade_intermediate_channels=8)
UNET_CASES = {
    "plain": {},
    "resblock_updown": dict(resblock_updown=True),
    "cross_attention": dict(with_conditioning=True, cross_attention_dim=6),
}


def _unet_pair(case: str, seed: int = 11):
    cfg = dict(UNET, **UNET_CASES[case])
    jmodel = JaxSPADEUNet(**cfg)
    x, t, seg = jnp.zeros((B, 3, 8, 8)), jnp.zeros((B,), jnp.int32), jnp.zeros((B, 3, 16, 16))
    ctx = jnp.zeros((B, 4, 6)) if cfg.get("with_conditioning") else None
    struct = zoo_convert.params_structure(jmodel, x, t, seg, context=ctx)
    params = random_params(struct, seed)
    port = SPADEDiffusionModelUNet(**cfg)
    port.load_state_dict(spade_diffusion_model_unet_state_dict_from_jax(
        params, port.state_dict()), strict=True)
    return jmodel, params, port.eval(), struct


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_spade_unet_matches_jax(case):
    jmodel, params, port, _ = _unet_pair(case)
    x, seg = rand((B, 3, 8, 8), 12), segmap((B, LABEL_NC, 16, 16), 13)
    t = np.array([10, 700], np.int32)
    ctx = rand((B, 4, 6), 14) if case == "cross_attention" else None
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(seg),
                        context=None if ctx is None else jnp.asarray(ctx))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(seg),
                   context=None if ctx is None else torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    assert_close(got, want, NET_RTOL)
    assert "up_blocks.0.resnets.0.norm1.param_free_norm.N.weight" in port.state_dict()


def test_spade_unet_round_trips_through_zoo_convert():
    _, params, port, struct = _unet_pair("resblock_updown", seed=15)
    back = zoo_convert.convert_spade_diffusion_model_unet(port.state_dict(), struct)
    assert_round_trip(params, back)


NET = dict(spatial_dims=2, in_channels=1, out_channels=1, label_nc=LABEL_NC,
           input_shape=(16, 16), num_channels=(4, 8), z_dim=6, spade_intermediate_channels=8)


def _net_pair(seed: int = 16, **overrides):
    cfg = dict(NET, **overrides)
    jmodel = JaxSPADENet(**cfg)
    seg, x = jnp.zeros((B, LABEL_NC, 16, 16)), jnp.zeros((B, 1, 16, 16))
    struct = zoo_convert.params_structure(jmodel, seg, x, key=jax.random.PRNGKey(0))
    params = random_params(struct, seed)
    port = SPADENet(**cfg)
    port.load_state_dict(spade_network_state_dict_from_jax(
        params, port.state_dict(), cfg["num_channels"], cfg["input_shape"]), strict=True)
    return jmodel, params, port.eval(), struct


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_spade_network_matches_jax(mode):
    jmodel, params, port, _ = _net_pair(upsampling_mode=mode)
    x, seg = rand((B, 1, 16, 16), 17), segmap((B, LABEL_NC, 16, 16), 18)
    z = rand((B, 6), 19)
    mu, logvar = jmodel.apply({"params": params}, jnp.asarray(x),
                              method=lambda m, x: m.encoder(x))
    want = jmodel.apply({"params": params}, jnp.asarray(seg), jnp.asarray(z),
                        method=JaxSPADENet.decode)
    with torch.no_grad():
        t_mu, t_logvar = port.encoder(torch.from_numpy(x))
        got = port.decode(torch.from_numpy(seg), torch.from_numpy(z))
    assert_close(t_mu, mu, NET_RTOL)
    assert_close(t_logvar, logvar, NET_RTOL)
    assert_close(got, want, NET_RTOL)
    from generativemodels_tpu.networks.nets.spade_network import kld_loss as jax_kld
    assert_close(kld_loss(t_mu, t_logvar), jax_kld(mu, logvar), NET_RTOL)
    # the VAE forward draws z from the generator: the decode of that draw
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        image, kld = port(torch.from_numpy(seg), torch.from_numpy(x), generator=g)
        eps = torch.randn(t_mu.shape, generator=torch.Generator().manual_seed(3))
        redo = port.decode(torch.from_numpy(seg), eps * torch.exp(0.5 * t_logvar) + t_mu)
    torch.testing.assert_close(image, redo, rtol=0, atol=0)
    assert torch.isfinite(kld)


def test_spade_network_gan_mode_matches_jax():
    jmodel, params, port, _ = _net_pair(seed=20, is_vae=False, z_dim=None)
    seg = segmap((B, LABEL_NC, 16, 16), 21)
    (want,) = jmodel.apply({"params": params}, jnp.asarray(seg))
    with torch.no_grad():
        (got,) = port(torch.from_numpy(seg))
    assert_close(got, want, NET_RTOL)


def test_spade_network_round_trips_through_zoo_convert():
    _, params, port, struct = _net_pair(seed=22)
    back = zoo_convert.convert_spade_network(port.state_dict(), struct, NET["num_channels"],
                                             NET["input_shape"])
    assert_round_trip(params, back)
    # the flat latent's permutation: a JAX fc_mu column (s, c) is the port's (c, s)
    s, c = 3, 5  # spatial index, channel of the deepest (8-wide, 4x4) features
    np.testing.assert_array_equal(port.state_dict()["encoder.fc_mu.weight"][:, c * 16 + s],
                                  params["encoder"]["fc_mu"]["kernel"][s * 8 + c])
