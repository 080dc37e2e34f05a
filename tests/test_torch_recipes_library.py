"""The five library recipes of A10 against their JAX functions on the CPU.

anomaly (DDIM encode and decode), inpaint (RePaint), super_resolution,
classifier_guidance and diffusion_autoencoder. Networks carry the same
weights (drawn for JAX, converted); the noise is JAX's: each test replays
the JAX recipe's key splits and hands the port its draws in the order the
port's docstring states. A single step of a recipe on the real networks
is held at 1e-5 of the output's largest magnitude. Whole chains of three
to five steps run smooth stand-in models (the same function in both
frameworks: a random UNet's ~1e-6 forward difference spreads along a
free-running chain) and are held at 1e-4 of the largest magnitude.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import DiffusionModelEncoder as JaxEncoder
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu_torch.networks import (
    diffusion_model_encoder_state_dict_from_jax,
    semantic_encoder_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks import schedulers as tsched
from generativemodels_tpu_torch.networks.nets import DiffusionModelEncoder, DiffusionModelUNet
from generativemodels_tpu_torch.recipes import (
    anomaly,
    classifier_guidance,
    diffusion_autoencoder,
    inpaint,
    super_resolution,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

from .test_torch_unet import random_params

# the JAX recipes package re-exports functions under the modules' names
janomaly, jcg, jdae, jinpaint, jsr = (
    importlib.import_module(f"generativemodels_tpu.recipes.{name}")
    for name in ("anomaly", "classifier_guidance", "diffusion_autoencoder", "inpaint",
                 "super_resolution"))

pytestmark = pytest.mark.usefixtures("one_torch_thread")
STEP_RTOL = 1e-5
CHAIN_RTOL = 1e-4
B, HW = 2, 16
NET = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
           num_channels=(8, 8), attention_levels=(False, True), num_head_channels=8,
           norm_num_groups=8)


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and scale > 0
    assert float(np.abs(got - want).max()) <= rtol * scale, float(np.abs(got - want).max())


def _unet_pair(seed, in_channels=1, **overrides):
    cfg = dict(NET, in_channels=in_channels, **overrides)
    jnet = JaxUNet(**cfg)
    kw = {}
    if cfg.get("num_class_embeds"):
        kw["class_labels"] = jnp.zeros((B,), jnp.int32)
    if cfg.get("with_conditioning"):
        kw["context"] = jnp.zeros((B, 1, cfg["cross_attention_dim"]))
    params = random_params(zoo_convert.params_structure(
        jnet, jnp.zeros((B, in_channels, HW, HW)), jnp.zeros((B,), jnp.int32), **kw), seed)
    port = DiffusionModelUNet(**cfg)
    port.load_state_dict(unet_state_dict_from_jax(params, port.state_dict()), strict=True)
    return jnet, params, port.eval()


def _schedulers(name, steps, **kwargs):
    j = getattr(jsched, name)(num_train_timesteps=1000, **kwargs)
    t = getattr(tsched, name)(num_train_timesteps=1000, **kwargs)
    j.set_timesteps(steps)
    t.set_timesteps(steps)
    return j, t


def _smooth(tanh):
    def fn(x, t, *args, **kwargs):
        return 0.5 * tanh(x[:, :1]) + 1e-4 * t.reshape(-1, 1, 1, 1)

    return fn


JSMOOTH, TSMOOTH = _smooth(jnp.tanh), _smooth(torch.tanh)


def _key_draws(key, *shapes):
    """JAX's normal draws of each shape from keys split off `key` in turn,
    as `k, sub = split(k)` loops do; returns torch tensors."""
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape))))
    return out


# -- anomaly ------------------------------------------------------------------


def test_anomaly_single_steps_match_jax():
    """One encode step and one decode step on the real UNet."""
    jnet, params, port = _unet_pair(0)
    jsch, tsch = _schedulers("DDIMScheduler", 10)
    image = _rand(1, (B, 1, HW, HW))

    def jfn(x, t):
        return jnet.apply({"params": params}, x, t)

    with torch.no_grad():
        for fn in ("ddim_encode", "ddim_decode"):
            want = getattr(janomaly, fn)(jfn, jsch, jnp.asarray(image), 1)
            got = getattr(anomaly, fn)(port, tsch, torch.from_numpy(image), 1)
            _close(got, want, STEP_RTOL)


def test_anomaly_map_chain_matches_jax():
    jsch, tsch = _schedulers("DDIMScheduler", 10)
    image = _rand(2, (B, 1, HW, HW))
    j_rec, j_map = janomaly.anomaly_map(JSMOOTH, jsch, jnp.asarray(image), encode_steps=4)
    rec, amap = anomaly.anomaly_map(TSMOOTH, tsch, torch.from_numpy(image), encode_steps=4)
    _close(rec, j_rec, CHAIN_RTOL)
    _close(amap, j_map, CHAIN_RTOL)
    with pytest.raises(ValueError, match="past the schedule"):
        anomaly.ddim_decode(TSMOOTH, tsch, torch.from_numpy(image), 10)


# -- inpaint ------------------------------------------------------------------


def _inpaint_draws(seed, timesteps, resample, shape):
    """The JAX recipe's draws (inpaint.py), in the port's order."""
    key = jax.random.PRNGKey(seed)
    draws = [np.array(jax.random.normal(key, shape))]
    _, k = jax.random.split(key)
    for _ in timesteps:
        for _ in range(resample):
            k, k_known, k_step, k_renoise = jax.random.split(k, 4)
            draws += [np.array(jax.random.normal(kk, shape)) for kk in (k_known, k_step,
                                                                       k_renoise)]
    return [torch.from_numpy(d) for d in draws]


@pytest.mark.parametrize("real_unet", [True, False], ids=["unet_one_step", "smooth_chain"])
def test_inpaint_matches_jax(real_unet):
    if real_unet:
        jnet, params, port = _unet_pair(3)
        jfn = lambda x, t: jnet.apply({"params": params}, x, t)  # noqa: E731
        steps, resample, tfn, rtol = 1, 1, port, STEP_RTOL
    else:
        jfn, tfn, steps, resample, rtol = JSMOOTH, TSMOOTH, 3, 2, CHAIN_RTOL
    jsch, tsch = _schedulers("DDPMScheduler", steps)
    image = _rand(4, (B, 1, HW, HW))
    mask = (np.arange(HW)[None, None, None, :] >= HW // 2).astype(np.float32) * np.ones_like(image)
    want = jinpaint.inpaint(jfn, jsch, jnp.asarray(image), jnp.asarray(mask),
                            key=jax.random.PRNGKey(5), num_resample_steps=resample)
    noise = _inpaint_draws(5, jsch.timesteps, resample, image.shape)
    with torch.no_grad():
        got = inpaint.inpaint(tfn, tsch, torch.from_numpy(image), torch.from_numpy(mask),
                              num_resample_steps=resample, noise=noise)
    _close(got, want, rtol)


# -- super-resolution -------------------------------------------------------


def test_nearest_resize_is_jax_half_pixel_rule():
    """At a non-integer ratio (5 -> 8) the port's resample is
    `jax.image.resize`'s nearest, and torch's floor `nearest` is not."""
    x = _rand(6, (1, 2, 5, 5))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, 8, 8), method="nearest"))
    got = super_resolution._resize_spatial(torch.from_numpy(x), (8, 8), "nearest")
    np.testing.assert_array_equal(got.numpy(), want)
    floor = F.interpolate(torch.from_numpy(x), size=(8, 8), mode="nearest").numpy()
    assert not np.array_equal(floor, want)


def test_prepare_sr_batch_and_scale_factor_match_jax():
    jsch, tsch = _schedulers("DDPMScheduler", 10)
    low = _rand(7, (B, 1, 8, 8))
    key = jax.random.PRNGKey(8)
    j_noised, j_level = jsr.prepare_sr_batch(jnp.asarray(low), jsch, key)
    k_level, k_noise = jax.random.split(key)
    noised, level = super_resolution.prepare_sr_batch(
        torch.from_numpy(low), tsch,
        noise_level=torch.from_numpy(np.asarray(j_level).astype(np.int64)),
        noise=torch.from_numpy(np.array(jax.random.normal(k_noise, low.shape))))
    _close(noised, j_noised, STEP_RTOL)
    drawn, drawn_level = super_resolution.prepare_sr_batch(
        torch.from_numpy(low), tsch, torch.Generator().manual_seed(0), max_noise_level=350)
    assert drawn.shape == low.shape and int(drawn_level.max()) < 350
    np.testing.assert_allclose(super_resolution.compute_scale_factor(torch.from_numpy(low)),
                               jsr.compute_scale_factor(jnp.asarray(low)), rtol=1e-6)


def _sr_draws(seed, steps, high, low):
    k_init, k_cond, k_loop = jax.random.split(jax.random.PRNGKey(seed), 3)
    draws = [np.array(jax.random.normal(k_init, high)), np.array(jax.random.normal(k_cond, low))]
    draws = [torch.from_numpy(d) for d in draws]
    return draws + _key_draws(k_loop, *[high] * steps)


@pytest.mark.parametrize("real_unet", [True, False], ids=["unet_one_step", "smooth_chain"])
def test_sample_super_resolution_matches_jax(real_unet):
    low = _rand(9, (B, 1, 8, 8))
    if real_unet:
        jnet, params, port = _unet_pair(10, in_channels=2, num_class_embeds=400)
        jfn = lambda x, t, c: jnet.apply({"params": params}, x, t, class_labels=c)  # noqa: E731
        tfn = lambda x, t, c: port(x, t, class_labels=c)  # noqa: E731
        steps, rtol = 1, STEP_RTOL
    else:
        jfn = lambda x, t, c: JSMOOTH(x, t) + 1e-3 * c.reshape(-1, 1, 1, 1)  # noqa: E731
        tfn = lambda x, t, c: TSMOOTH(x, t) + 1e-3 * c.reshape(-1, 1, 1, 1)  # noqa: E731
        steps, rtol = 4, CHAIN_RTOL
    jsch, tsch = _schedulers("DDPMScheduler", steps)
    want = jsr.sample_super_resolution(jfn, jsch, jnp.asarray(low), 2, noise_level=30,
                                       key=jax.random.PRNGKey(11))
    noise = _sr_draws(11, steps, (B, 1, HW, HW), low.shape)
    with torch.no_grad():
        got = super_resolution.sample_super_resolution(tfn, tsch, torch.from_numpy(low), 2,
                                                       noise_level=30, noise=noise)
    _close(got, want, rtol)


# -- classifier guidance ------------------------------------------------------


def _encoder_pair(seed):
    cfg = dict(NET, out_channels=3)
    x, t = _rand(12, (B, 1, HW, HW)), np.array([3, 500])
    jm = JaxEncoder(**cfg)
    params = random_params(zoo_convert.params_structure(
        jm, jnp.asarray(x), jnp.asarray(t, jnp.int32)), seed)
    port = DiffusionModelEncoder(**cfg).eval()
    with torch.no_grad():  # materialises out.0 at its input width
        port(torch.from_numpy(x), torch.from_numpy(t))
    port.load_state_dict(diffusion_model_encoder_state_dict_from_jax(params, port.state_dict()))
    return jm, params, port


@pytest.mark.parametrize("scheduler", ["DDIMScheduler", "DDPMScheduler"])
def test_classifier_guided_step_matches_jax(scheduler):
    """One guided step on the real UNet and DiffusionModelEncoder: the
    classifier's gradient with respect to x is taken inside the loop."""
    jnet, params, port = _unet_pair(13)
    jenc, eparams, enc = _encoder_pair(14)
    jsch, tsch = _schedulers(scheduler, 1)
    x = _rand(15, (B, 1, HW, HW))
    target = np.array([2, 0])
    key = jax.random.PRNGKey(16)
    want = jcg.sample_with_classifier_guidance(
        lambda xx, t: jnet.apply({"params": params}, xx, t),
        lambda xx, t: jenc.apply({"params": eparams}, xx, t),
        jsch, jnp.asarray(x), jnp.asarray(target), guidance_scale=3.0, key=key)
    noise = _key_draws(key, x.shape)
    with torch.no_grad():
        got = classifier_guidance.sample_with_classifier_guidance(
            port, enc, tsch, torch.from_numpy(x), torch.from_numpy(target),
            guidance_scale=3.0, noise=noise)
    _close(got, want, STEP_RTOL)


def test_classifier_guided_chain_matches_jax():
    def logits(tanh, stack, mean):
        return lambda x, t: stack([mean(tanh(x), (1, 2, 3)), mean(x * x, (1, 2, 3)),
                                   mean(tanh(2 * x) * x, (1, 2, 3))], -1)

    jcls = logits(jnp.tanh, jnp.stack, lambda a, d: jnp.mean(a, axis=d))
    tcls = logits(torch.tanh, torch.stack, lambda a, d: torch.mean(a, dim=d))
    jsch, tsch = _schedulers("DDPMScheduler", 4)
    x = _rand(17, (B, 1, HW, HW))
    target = np.array([1, 2])
    key = jax.random.PRNGKey(18)
    want = jcg.sample_with_classifier_guidance(JSMOOTH, jcls, jsch, jnp.asarray(x),
                                               jnp.asarray(target), guidance_scale=2.0, key=key)
    got = classifier_guidance.sample_with_classifier_guidance(
        TSMOOTH, tcls, tsch, torch.from_numpy(x), torch.from_numpy(target),
        guidance_scale=2.0, noise=_key_draws(key, *[x.shape] * 4))
    _close(got, want, CHAIN_RTOL)


# -- diffusion autoencoder ---------------------------------------------------


def _semantic_pair(seed, emb_dim=8):
    jm = jdae.SemanticEncoder(emb_dim=emb_dim, widths=(8, 16))
    params = random_params(zoo_convert.params_structure(jm, jnp.zeros((B, 1, HW, HW))), seed)
    port = diffusion_autoencoder.SemanticEncoder(2, 1, emb_dim=emb_dim, widths=(8, 16))
    port.load_state_dict(semantic_encoder_state_dict_from_jax(params, port.state_dict()),
                         strict=True)
    return jm, params, port.eval()


def test_semantic_encoder_and_loss_match_jax():
    jm, eparams, enc = _semantic_pair(19)
    jnet, params, port = _unet_pair(20, with_conditioning=True, cross_attention_dim=8)
    images = _rand(21, (B, 1, HW, HW))
    with torch.no_grad():
        code = enc(torch.from_numpy(images))
    assert code.shape == (B, 1, 8)
    _close(code, jm.apply({"params": eparams}, jnp.asarray(images)), STEP_RTOL)

    key = jax.random.PRNGKey(22)
    want = jdae.diffusion_autoencoder_loss(
        lambda x, t, c: jnet.apply({"params": params}, x, t, context=c),
        lambda x: jm.apply({"params": eparams}, x), jsched.DDPMScheduler(num_train_timesteps=1000),
        jnp.asarray(images), key)
    k_noise, k_t = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.normal(k_noise, images.shape)))
    timesteps = torch.from_numpy(np.asarray(jax.random.randint(k_t, (B,), 0, 1000)).astype(
        np.int64))
    with torch.no_grad():
        got = diffusion_autoencoder.diffusion_autoencoder_loss(
            lambda x, t, c: port(x, t, context=c), enc,
            tsched.DDPMScheduler(num_train_timesteps=1000), torch.from_numpy(images),
            noise=noise, timesteps=timesteps)
    np.testing.assert_allclose(got.item(), float(want), rtol=STEP_RTOL)


def test_diffusion_autoencoder_reconstruct_chain_matches_jax():
    jm, eparams, enc = _semantic_pair(23)

    jfn = lambda x, t, c: 0.5 * jnp.tanh(x) + 1e-4 * t.reshape(-1, 1, 1, 1) + 0.1 * jnp.mean(  # noqa: E731
        c, axis=(1, 2)).reshape(-1, 1, 1, 1)
    tfn = lambda x, t, c: 0.5 * torch.tanh(x) + 1e-4 * t.reshape(-1, 1, 1, 1) + 0.1 * torch.mean(  # noqa: E731
        c, dim=(1, 2)).reshape(-1, 1, 1, 1)
    jsch, tsch = _schedulers("DDPMScheduler", 4)
    images = _rand(24, (B, 1, HW, HW))
    key = jax.random.PRNGKey(25)
    want = jdae.reconstruct(jfn, lambda x: jm.apply({"params": eparams}, x), jsch,
                            jnp.asarray(images), key=key)
    k_init, k_loop = jax.random.split(key)
    noise = [torch.from_numpy(np.array(jax.random.normal(k_init, images.shape)))]
    noise += _key_draws(k_loop, *[images.shape] * 4)
    with torch.no_grad():
        got = diffusion_autoencoder.reconstruct(tfn, enc, tsch, torch.from_numpy(images),
                                                noise=noise)
    _close(got, want, CHAIN_RTOL)
