"""The port's ControlNet, `copy_weights_to_controlnet` and the two ControlNet
inferers against the JAX ones, with carried-over weights.

A small conditioned 2D UNet ((16, 32), attention on level 1, 16-wide heads,
8 groups, a (B, 3, 6) context) with its ControlNet, every JAX parameter
drawn from a numpy seed (the zero-initialised convs included, so the
control residuals are not zero) and carried over by networks/convert.py.
Forwards compare at atol = rtol = 1e-4 (tests/test_torch_unet.py's
tolerance for a whole UNet); sampling chains (DDIM-5, eta 0) at max|diff|
<= 1e-4 of max|JAX output|, a random UNet's per-forward ~1e-6 grown a few
times over the steps.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.inferers.controlnet import (
    ControlNetDiffusionInferer as JaxCNInferer,
    ControlNetLatentDiffusionInferer as JaxCNLatentInferer,
)
from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import ControlNet as JaxControlNet
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu.networks.nets.controlnet import (
    copy_weights_to_controlnet as jax_copy_weights,
)
from generativemodels_tpu_torch.inferers import (
    ControlNetDiffusionInferer,
    ControlNetLatentDiffusionInferer,
)
from generativemodels_tpu_torch.inferers import latent as port_latent
from generativemodels_tpu_torch.networks import (
    controlnet_state_dict_from_jax,
    schedulers as tsched,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import (
    ControlNet,
    DiffusionModelUNet,
    copy_weights_to_controlnet,
)

from .test_torch_latent import IMAGE, LATENT, aekl  # noqa: F401  (aekl: a fixture)
from .test_torch_unet import random_params
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=1e-4, rtol=1e-4)
CHAIN_RTOL = 1e-4
BATCH = 2
NET = dict(
    spatial_dims=2, in_channels=1, num_res_blocks=1, num_channels=(16, 32),
    attention_levels=(False, True), num_head_channels=16, norm_num_groups=8,
    with_conditioning=True, cross_attention_dim=6,
)
CN = dict(conditioning_embedding_in_channels=1, conditioning_embedding_num_channels=(8, 16))
SPATIAL = (8, 8)
COND_SPATIAL = (16, 16)  # one stride-2 conv in the conditioning embedding


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def build(seed=0, spatial=SPATIAL, cond_spatial=COND_SPATIAL, **overrides):
    """JAX and port UNet and ControlNet with the same weights: (jax unet,
    unet params, port unet, jax controlnet, controlnet params, port controlnet)."""
    cfg = dict(NET, **overrides.pop("net", {}))
    cn_cfg = dict(cfg, **dict(CN, **overrides))
    x = jnp.zeros((BATCH, cfg["in_channels"], *spatial))
    t = jnp.zeros((BATCH,), jnp.int32)
    ctx = dict(context=jnp.zeros((BATCH, 3, 6))) if cfg["with_conditioning"] else {}
    jnet = JaxUNet(out_channels=cfg["in_channels"], **cfg)
    unet_params = random_params(zoo_convert.params_structure(jnet, x, t, **ctx), seed)
    net = DiffusionModelUNet(out_channels=cfg["in_channels"], **cfg)
    net.load_state_dict(unet_state_dict_from_jax(unet_params, net.state_dict()), strict=True)
    jcn = JaxControlNet(**cn_cfg)
    cond = jnp.zeros((BATCH, 1, *cond_spatial))
    cn_params = random_params(
        zoo_convert.params_structure(jcn, x, t, controlnet_cond=cond, **ctx), seed + 1)
    cn = ControlNet(**cn_cfg)
    cn.load_state_dict(controlnet_state_dict_from_jax(cn_params, cn.state_dict()), strict=True)
    return jnet, unet_params, net.eval(), jcn, cn_params, cn.eval()


@pytest.mark.parametrize("with_conditioning", [True, False], ids=["cross", "self"])
def test_controlnet_matches_jax(with_conditioning):
    _, _, _, jcn, params, cn = build(
        net=dict(with_conditioning=with_conditioning,
                 cross_attention_dim=6 if with_conditioning else None))
    x, cond, ctx = _rand(1, (BATCH, 1, *SPATIAL)), _rand(2, (BATCH, 1, *COND_SPATIAL)), _rand(
        3, (BATCH, 3, 6))
    t = np.array([10, 600], dtype=np.int64)
    jkw = dict(context=jnp.asarray(ctx)) if with_conditioning else {}
    tkw = dict(context=torch.from_numpy(ctx)) if with_conditioning else {}
    j_down, j_mid = jcn.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                              controlnet_cond=jnp.asarray(cond), conditioning_scale=0.7, **jkw)
    with torch.no_grad():
        down, mid = cn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                       conditioning_scale=0.7, **tkw)
    assert len(down) == len(j_down) == 4  # conv_in, a resnet, a downsampler, a resnet
    for a, b in zip(down + [mid], list(j_down) + [j_mid]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    fresh = ControlNet(**NET, **CN)  # the control heads start at zero
    assert all(not p.abs().sum() for p in fresh.controlnet_mid_block.parameters())


def test_copy_weights_to_controlnet_matches_jax():
    """The port copies every shared key of the same shape into the
    ControlNet in place, as JAX's function returns them: the two results
    agree parameter by parameter. The UNet is left as it was, and the
    copies hold their own storage."""
    _, unet_params, net, jcn, cn_params, cn = build(seed=4)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert copy_weights_to_controlnet(cn, net, verbose=False) is cn
    j_params = jax_copy_weights(cn_params, unet_params, verbose=False)
    want = controlnet_state_dict_from_jax(j_params, cn.state_dict())
    got = cn.state_dict()
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    assert torch.equal(got["conv_in.conv.weight"], net.conv_in.conv.weight)
    assert not torch.equal(got["controlnet_mid_block.conv.weight"],
                           torch.zeros_like(got["controlnet_mid_block.conv.weight"]))
    with torch.no_grad():
        cn.conv_in.conv.weight.add_(1.0)
    for key, value in net.state_dict().items():
        torch.testing.assert_close(value, before[key], rtol=0, atol=0)


def _callables(jnet, unet_params, net, jcn, cn_params, cn):
    def jmodel(x, t, context=None, **kw):
        return jnet.apply({"params": unet_params}, x, t, context=context, **kw)

    def jcontrol(x, t, controlnet_cond=None, context=None):
        return jcn.apply({"params": cn_params}, x, t, controlnet_cond=controlnet_cond,
                         context=context)

    return jmodel, jcontrol, net, cn


def _assert_close(got, want, rtol):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and scale > 0
    assert float(np.abs(got.detach().numpy() - want).max()) <= rtol * scale


def test_controlnet_inferer_matches_jax():
    """The training forward with injected noise and timesteps, and a DDIM-5
    sample, each with a ControlNet forward before every UNet call."""
    jmodel, jcontrol, net, cn = _callables(*build(seed=6))
    x, noise = _rand(7, (BATCH, 1, *SPATIAL)), _rand(8, (BATCH, 1, *SPATIAL))
    cond, ctx = _rand(9, (BATCH, 1, *COND_SPATIAL)), _rand(10, (BATCH, 3, 6))
    t = np.array([50, 900], dtype=np.int64)
    jinf = JaxCNInferer(jsched.DDIMScheduler(num_train_timesteps=1000))
    tinf = ControlNetDiffusionInferer(tsched.DDIMScheduler(num_train_timesteps=1000))
    want = jinf(jnp.asarray(x), jmodel, jcontrol, jnp.asarray(noise), jnp.asarray(t, jnp.int32),
                cn_cond=jnp.asarray(cond), condition=jnp.asarray(ctx))
    with torch.no_grad():
        got = tinf(torch.from_numpy(x), net, cn, torch.from_numpy(noise), torch.from_numpy(t),
                   cn_cond=torch.from_numpy(cond), condition=torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jinf.scheduler.set_timesteps(5)
    tinf.scheduler.set_timesteps(5)
    want = jinf.sample(jnp.asarray(noise), jmodel, jcontrol, jnp.asarray(cond),
                       conditioning=jnp.asarray(ctx))
    with torch.no_grad():
        got = tinf.sample(torch.from_numpy(noise), net, cn, torch.from_numpy(cond),
                          conditioning=torch.from_numpy(ctx))
    _assert_close(got, want, CHAIN_RTOL)


def test_fit_cn_cond_takes_the_floor_rule():
    """6 -> 4 and 9 -> 4: the floor rule (torch's nearest, the JAX module's
    and the reference's) picks source pixels 0, 1, 3, 4 and 0, 2, 4, 6;
    nearest-exact (latent.py's resampling) would pick 0, 2, 3, 5 and
    1, 3, 5, 7."""
    cond = _rand(11, (1, 2, 6, 9))
    latent = np.zeros((1, 3, 4, 4), np.float32)
    got = ControlNetLatentDiffusionInferer._fit_cn_cond(torch.from_numpy(cond),
                                                        torch.from_numpy(latent))
    want = JaxCNLatentInferer._fit_cn_cond(jnp.asarray(cond), jnp.asarray(latent))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), cond[:, :, [0, 1, 3, 4]][:, :, :, [0, 2, 4, 6]])
    exact = port_latent._resize_spatial(torch.from_numpy(cond), (4, 4), "nearest")
    assert not torch.equal(got, exact)


def test_controlnet_latent_inferer_matches_jax(aekl):  # noqa: F811
    """The latent variant around the small AutoencoderKL of
    tests/test_torch_latent.py: a 12x12 control image fitted to the 8x8
    latent by the floor rule, a DDIM-5 sample decoded, on both sides."""
    jstage1, tstage1 = aekl
    overrides = dict(net=dict(in_channels=3), conditioning_embedding_num_channels=(8,))
    jmodel, jcontrol, net, cn = _callables(
        *build(seed=12, spatial=LATENT[2:], cond_spatial=LATENT[2:], **overrides))
    noise = _rand(13, LATENT)
    cond, ctx = _rand(14, (BATCH, 1, 12, 12)), _rand(15, (BATCH, 3, 6))
    jinf = JaxCNLatentInferer(jsched.DDIMScheduler(num_train_timesteps=1000), scale_factor=0.5)
    tinf = ControlNetLatentDiffusionInferer(tsched.DDIMScheduler(num_train_timesteps=1000),
                                           scale_factor=0.5)
    jinf.scheduler.set_timesteps(5)
    tinf.scheduler.set_timesteps(5)
    want = jinf.sample(jnp.asarray(noise), jstage1, jmodel, jcontrol, jnp.asarray(cond),
                       conditioning=jnp.asarray(ctx))
    with torch.no_grad():
        got = tinf.sample(torch.from_numpy(noise), tstage1, net, cn, torch.from_numpy(cond),
                          conditioning=torch.from_numpy(ctx))
    assert got.shape == IMAGE
    _assert_close(got, want, CHAIN_RTOL)
