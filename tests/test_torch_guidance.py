"""The port's classifier-free guidance and the brain LDM sampler against the
JAX recipes.

`sample_with_guidance` runs with a smooth stand-in model (a random UNet's
chain is chaotic: tests/test_torch_latent.py) that reads its context, so
that the guided combination matters, under DDIM (eta 0), DDPM (the JAX
recipe's per-step key noise, drawn here and passed to the port) and
DPM-Solver++(2M); whole chains compare at max|diff| <= 1e-5 of max|JAX
output| (f32 sums in another order). One guided step is held against
`uncond + g * (cond - uncond)` from two separate forwards. The brain LDM
sampler runs the JAX recipe's `--tiny` networks (built from the preset's
numbers) with the same weights and noise, DDIM-5, compared at 1e-4 of the
largest output (a random UNet over five steps, then the decoder).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.config import load_preset
from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.recipes import brain_ldm_sampler as jbrain
from generativemodels_tpu.recipes import guidance as jguidance
from generativemodels_tpu_torch.networks import (
    autoencoderkl_state_dict_from_jax,
    schedulers as tsched,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.convert import _translate_unet
from generativemodels_tpu_torch.recipes import brain_ldm_sampler as tbrain
from generativemodels_tpu_torch.recipes import guidance as tguidance

from .test_torch_unet import random_params
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
SHAPE = (2, 1, 6, 6)
GUIDANCE = 7.0


def _rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _model(xp):
    """A smooth model whose prediction depends on x, t and the context."""
    def fn(x, t, context):
        tt = (t.astype(xp.float32) if xp is jnp else t.float()) / 1000.0
        c = context.mean(axis=(1, 2)) if xp is jnp else context.mean(dim=(1, 2))
        return 0.3 * xp.tanh(x) + 0.1 * tt.reshape(-1, 1, 1, 1) + 0.05 * c.reshape(-1, 1, 1, 1)
    return fn


def _assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert got.shape == want.shape and scale > 0
    assert float(np.abs(got.numpy() - want).max()) <= rtol * scale


SCHEDULERS = {
    "ddim": (jsched.DDIMScheduler, tsched.DDIMScheduler, 10),
    "ddpm": (jsched.DDPMScheduler, tsched.DDPMScheduler, 10),
    "dpmsolver": (jsched.DPMSolverMultistepScheduler, tsched.DPMSolverMultistepScheduler, 10),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_sample_with_guidance_matches_jax(name):
    jcls, tcls, steps = SCHEDULERS[name]
    js, ts = jcls(num_train_timesteps=1000), tcls(num_train_timesteps=1000)
    js.set_timesteps(steps)
    ts.set_timesteps(steps)
    noise = _rand(0, SHAPE)
    cond, uncond = _rand(1, (2, 3, 4)), np.zeros((2, 3, 4), np.float32)
    key = jax.random.PRNGKey(3)
    want = jguidance.sample_with_guidance(
        _model(jnp), js, jnp.asarray(noise), jnp.asarray(cond), jnp.asarray(uncond),
        guidance_scale=GUIDANCE, key=key)
    step_noise = None
    if name == "ddpm":  # the recipe's scan splits its key once a step
        step_noise, k = [], key
        for _ in range(steps):
            k, sub = jax.random.split(k)
            step_noise.append(torch.from_numpy(np.array(
                jax.random.normal(sub, SHAPE, dtype=jnp.float32))))
    got = tguidance.sample_with_guidance(
        _model(torch), ts, torch.from_numpy(noise), torch.from_numpy(cond),
        torch.from_numpy(uncond), guidance_scale=GUIDANCE, noise=step_noise)
    _assert_close(got, want)


def test_guided_step_is_the_guided_combination():
    """One guided DDIM step equals the step of uncond + g (cond - uncond),
    the two predictions from separate forwards."""
    ts = tsched.DDIMScheduler(num_train_timesteps=1000)
    ts.set_timesteps(5)
    ts_ref = tsched.DDIMScheduler(num_train_timesteps=1000)
    ts_ref.set_timesteps(5)
    x = torch.from_numpy(_rand(4, SHAPE))
    cond, uncond = torch.from_numpy(_rand(5, (2, 3, 4))), torch.zeros(2, 3, 4)
    model = _model(torch)
    t = ts.timesteps[0]
    guided = tguidance.guided_prediction(model, x, t, cond, uncond, GUIDANCE)
    tt = t.expand(2)
    c, u = model(x, tt, cond), model(x, tt, uncond)
    torch.testing.assert_close(guided, u + GUIDANCE * (c - u), rtol=1e-6, atol=1e-6)
    got = tguidance.sample_with_guidance(model, ts, x, cond, uncond, GUIDANCE)
    want = x
    for t in ts_ref.timesteps:
        tt = t.expand(2)
        c, u = model(want, tt, cond), model(want, tt, uncond)
        want, _ = ts_ref.step(u + GUIDANCE * (c - u), t, want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_drop_condition():
    cond = torch.arange(1.0, 9.0).reshape(8, 1)
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(tguidance.drop_condition(cond, -1.0, 0.0, g), cond)
    assert bool((tguidance.drop_condition(cond, -1.0, 1.0, g) == -1.0).all())
    dropped = tguidance.drop_condition(cond.expand(8, 3), -1.0, 0.5, g)
    rows = (dropped == -1.0).all(dim=1) | (dropped == cond).all(dim=1)
    assert bool(rows.all())  # a whole element is dropped or kept


TINY_UNET = dict(num_channels=(8, 8), attention_levels=(False, True), num_head_channels=8,
                 norm_num_groups=8)
TINY_AEKL = dict(num_channels=(8, 8), attention_levels=(False, False), norm_num_groups=8)


def test_sample_brain_ldm_matches_jax():
    """The JAX recipe's --tiny networks (`eval_brain_ldm.py:103-110`) from
    the preset, the port's from the same numbers, the same weights and
    latent noise; the preset's DDIM, five steps; the covariates as context."""
    preset = load_preset("brain_3d_ldm")
    junet = preset.resolve("network").clone(in_channels=3, **TINY_UNET)
    jaekl = preset.resolve("autoencoder").clone(**TINY_AEKL)
    latent = (1, 3, 4, 4, 4)
    up = zoo_convert.params_structure(junet, jnp.zeros(latent), jnp.zeros((1,), jnp.int32),
                                      context=jnp.zeros((1, 1, 4)))
    ap = zoo_convert.params_structure(jaekl, jnp.zeros((1, 1, 8, 8, 8)))
    unet_params, aekl_params = random_params(up, 0), random_params(ap, 1)
    unet = tbrain.brain_unet(**TINY_UNET).eval()
    unet.load_state_dict(unet_state_dict_from_jax(unet_params, unet.state_dict()), strict=True)
    aekl = tbrain.brain_autoencoder(**TINY_AEKL).eval()
    aekl.load_state_dict(autoencoderkl_state_dict_from_jax(
        aekl_params, aekl.state_dict(), TINY_AEKL["num_channels"], 2,
        TINY_AEKL["attention_levels"], False, False), strict=True)

    key = jax.random.PRNGKey(7)
    k_noise, _ = jax.random.split(key)
    noise = np.array(jax.random.normal(k_noise, latent))
    covariates = dict(gender=1.0, age=0.3, ventricular_vol=0.4, brain_vol=0.6)
    want = jbrain.sample_brain_ldm(
        lambda x, t, context=None: junet.apply({"params": unet_params}, x, t, context=context),
        jaekl.bind({"params": aekl_params}), preset.resolve("scheduler"), latent,
        num_inference_steps=5, key=key, **covariates)
    scheduler = tsched.DDIMScheduler(num_train_timesteps=1000, schedule="scaled_linear_beta",
                                     beta_start=0.0015, beta_end=0.0205, clip_sample=False)
    with torch.no_grad():
        got = tbrain.sample_brain_ldm(unet, aekl, scheduler, latent, num_inference_steps=5,
                                      noise=torch.from_numpy(noise), **covariates)
    assert got.shape == (1, 1, 8, 8, 8)
    _assert_close(got, want, rtol=1e-4)
    ctx = tbrain.make_conditioning(**covariates, batch=2, device="cpu")
    np.testing.assert_array_equal(ctx.numpy(),
                                  np.asarray(jbrain.make_conditioning(**covariates, batch=2)))


def test_sample_brain_ldm_runs_on_the_cpu_only_when_asked():
    """With no noise, `device="cpu"` draws the latent from a CPU generator
    seeded 0 and samples there; with no device the sampler asks for the card
    (and raises on a machine without one)."""
    unet = tbrain.brain_unet(**TINY_UNET).eval()
    aekl = tbrain.brain_autoencoder(**TINY_AEKL).eval()
    scheduler = tsched.DDIMScheduler(num_train_timesteps=1000, clip_sample=False)
    latent = (1, 3, 4, 4, 4)
    with torch.no_grad():
        got = tbrain.sample_brain_ldm(unet, aekl, scheduler, latent, num_inference_steps=2,
                                      device="cpu")
        noise = torch.randn(latent, generator=torch.Generator("cpu").manual_seed(0))
        want = tbrain.sample_brain_ldm(unet, aekl, scheduler, latent, num_inference_steps=2,
                                       noise=noise)
    assert got.device.type == "cpu" and got.shape == (1, 1, 8, 8, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tbrain.make_conditioning(0.0, 0.5, 0.5, 0.5, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tbrain.sample_brain_ldm(unet, aekl, scheduler, latent, num_inference_steps=2)


def _torch_shape(leaf: str, shape: tuple) -> tuple:
    if leaf == "kernel" and len(shape) >= 3:  # (*k, I, O) -> (O, I, *k)
        return (shape[-1], shape[-2], *shape[:-2])
    if leaf == "kernel":
        return shape[::-1]
    return shape


def test_brain_unet_is_the_preset_at_full_width():
    """The port's full-width brain UNet (built on the meta device, no
    memory) has a parameter for each of the JAX preset network's (with the
    recipe's in_channels 3), key by key and shape by shape."""
    junet = load_preset("brain_3d_ldm").resolve("network").clone(in_channels=3)
    struct = zoo_convert.params_structure(junet, jnp.zeros((1, 3, 8, 8, 8)),
                                          jnp.zeros((1,), jnp.int32), context=jnp.zeros((1, 1, 4)))
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in tbrain.brain_unet().state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(struct):
        names = [p.key for p in path]
        prefix = _translate_unet(tuple(names[:-1]))
        name = "bias" if names[-1] == "bias" else "weight"
        key = f"{prefix}.{name}" if f"{prefix}.{name}" in shapes else f"{prefix}.conv.{name}"
        want[key] = _torch_shape(names[-1], tuple(leaf.shape))
    assert want == shapes
