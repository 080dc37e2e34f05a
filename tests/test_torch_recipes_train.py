"""The three training recipes of A10 against their JAX functions on the CPU.

train_controlnet (the ControlNet trained with the UNet frozen),
segmentation_ddpm (a mask DDPM conditioned by concatenation, and its
sampling ensemble) and compare_schedulers (one trained model sampled by
each scheduler). Networks carry the same weights (drawn for JAX,
converted), and each step takes the JAX step's draws. A step's loss is held
at 1e-5 (relative) and the updated parameters as the 2D DDPM step's test
holds them (Adam with eps 1e-3: rtol 1e-4, atol 1e-6); the ControlNet step
leaves every UNet weight equal to the bit. Sampling chains of three to
four steps run a smooth stand-in model and are held at 1e-4 of the largest
magnitude. Each `main()` runs at a tiny size.
"""
from __future__ import annotations

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import ControlNet as JaxControlNet
from generativemodels_tpu.parallel import init_train_state as jax_init_train_state
from generativemodels_tpu_torch.networks import controlnet_state_dict_from_jax
from generativemodels_tpu_torch.networks import schedulers as tsched
from generativemodels_tpu_torch.networks.nets import ControlNet
from generativemodels_tpu_torch.parallel import init_train_state
from generativemodels_tpu_torch.recipes import (
    compare_schedulers,
    segmentation_ddpm,
    train_controlnet,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

from .test_torch_recipes_library import (
    B,
    HW,
    JSMOOTH,
    NET,
    TSMOOTH,
    _close,
    _key_draws,
    _rand,
    _unet_pair,
)
from .test_torch_train import _to_port_layout
from .test_torch_unet import random_params

jcn_recipe, jseg, jcmp = (
    importlib.import_module(f"generativemodels_tpu.recipes.{name}")
    for name in ("train_controlnet", "segmentation_ddpm", "compare_schedulers"))

pytestmark = pytest.mark.usefixtures("one_torch_thread")
LOSS_RTOL = 1e-5
LR, EPS = 1e-4, 1e-3
CHAIN_RTOL = 1e-4


def _draws(rng, like, T=1000):
    """The noise and timesteps a JAX recipe step draws from `rng`."""
    k_noise, k_t = jax.random.split(rng)
    noise = np.array(jax.random.normal(k_noise, like.shape, dtype=like.dtype))
    timesteps = np.asarray(jax.random.randint(k_t, (like.shape[0],), 0, T)).astype(np.int64)
    return torch.from_numpy(noise), torch.from_numpy(timesteps)


def _masked(seed):
    images = np.random.RandomState(seed).uniform(0, 1, (B, 1, HW, HW)).astype(np.float32)
    return images, (images > 0.3).astype(np.float32)


def test_synthetic_masked_batch_is_a_threshold_of_blobs():
    images, masks = train_controlnet.synthetic_masked_batch(torch.Generator().manual_seed(0),
                                                            2, 16)
    assert images.shape == masks.shape == (2, 1, 16, 16)
    assert set(torch.unique(masks).tolist()) <= {0.0, 1.0}
    torch.testing.assert_close(masks, (images > 0.3).float(), rtol=0, atol=0)


def test_controlnet_step_matches_jax_and_leaves_the_unet():
    jnet, unet_params, unet = _unet_pair(30)
    cfg = dict(NET, conditioning_embedding_num_channels=(8,))
    cfg.pop("out_channels")
    jcn = JaxControlNet(**cfg)
    x = jnp.zeros((B, 1, HW, HW))
    cn_params = random_params(zoo_convert.params_structure(
        jcn, x, jnp.zeros((B,), jnp.int32), controlnet_cond=x), 31)
    cn = ControlNet(**cfg)
    cn.load_state_dict(controlnet_state_dict_from_jax(cn_params, cn.state_dict()), strict=True)
    unet.train(), cn.train()
    unet_before = {k: v.clone() for k, v in unet.state_dict().items()}
    cn_before = {k: v.detach().clone() for k, v in cn.named_parameters()}

    tx = optax.adam(LR, eps=EPS)
    jstep = jcn_recipe.make_controlnet_train_step(
        lambda noisy, t, down, mid: jnet.apply(
            {"params": unet_params}, noisy, t, down_block_additional_residuals=down,
            mid_block_additional_residual=mid),
        lambda p, noisy, t, masks: jcn.apply({"params": p}, noisy, t, controlnet_cond=masks),
        jsched.DDPMScheduler(num_train_timesteps=1000), tx)
    jstate = jax_init_train_state(cn_params, tx)
    step = train_controlnet.make_controlnet_train_step(
        unet, tsched.DDPMScheduler(num_train_timesteps=1000))
    assert not any(p.requires_grad for p in unet.parameters())
    state = init_train_state(cn, torch.optim.Adam(cn.parameters(), lr=LR, eps=EPS))
    images, masks = _masked(32)
    rng = jax.random.PRNGKey(33)
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(masks), sub)
        state, loss = step.update(state, torch.from_numpy(images), torch.from_numpy(masks),
                                  *_draws(sub, images))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    assert state.step == 2
    for k, v in unet.state_dict().items():
        torch.testing.assert_close(v, unet_before[k], rtol=0, atol=0)
    want = controlnet_state_dict_from_jax(jax.device_get(jstate.params), cn.state_dict())
    for name, p in cn.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    moved = [name for name, p in cn.named_parameters() if not torch.equal(p, cn_before[name])]
    assert len(moved) > len(cn_before) // 2


def test_segmentation_step_matches_jax():
    jnet, params, port = _unet_pair(34, in_channels=2)
    port.train()
    tx = optax.adam(LR, eps=EPS)
    jstep = jseg.make_segmentation_train_step(
        lambda p, x, t: jnet.apply({"params": p}, x, t),
        jsched.DDPMScheduler(num_train_timesteps=1000), tx)
    jstate = jax_init_train_state(params, tx)
    step = segmentation_ddpm.make_segmentation_train_step(
        tsched.DDPMScheduler(num_train_timesteps=1000))
    state = init_train_state(port, torch.optim.Adam(port.parameters(), lr=LR, eps=EPS))
    images, masks = _masked(35)
    rng = jax.random.PRNGKey(36)
    jstate, jloss = jstep(jstate, jnp.asarray(images), jnp.asarray(masks), rng)
    state, loss = step.update(state, torch.from_numpy(images), torch.from_numpy(masks),
                              *_draws(rng, masks))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = _to_port_layout(jax.device_get(jstate.params), port)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_segmentation_ensemble_matches_jax():
    jsch = jsched.DDPMScheduler(num_train_timesteps=1000)
    tsch = tsched.DDPMScheduler(num_train_timesteps=1000)
    jsch.set_timesteps(3)
    tsch.set_timesteps(3)
    images, _ = _masked(37)
    key = jax.random.PRNGKey(38)
    j_mean, j_std = jseg.segment_with_uncertainty(jnp.asarray(images), JSMOOTH, jsch, key,
                                                  ensemble=2)
    noise = []
    for k in jax.random.split(key, 2):
        k_noise, k_samp = jax.random.split(k)
        noise.append(torch.from_numpy(np.array(jax.random.normal(k_noise, images.shape))))
        noise.append(torch.stack(_key_draws(k_samp, *[images.shape] * 3)))
    with torch.no_grad():
        mean, std = segmentation_ddpm.segment_with_uncertainty(
            torch.from_numpy(images), TSMOOTH, tsch, ensemble=2, noise=noise)
    _close(mean, j_mean, CHAIN_RTOL)
    _close(std, j_std, CHAIN_RTOL)
    assert float(std.mean()) > 0


@pytest.mark.parametrize("name", ["DDIM", "PNDM", "DPM-Solver++", "DDPM"])
def test_compare_schedulers_samplers_match_jax(name):
    """Each scheduler's chain from the recipe's noise and seed-11 key (the
    DDPM chain with the JAX key's draws injected)."""
    _, cls, kwargs = next(s for s in compare_schedulers.SCHEDULERS if s[0] == name)
    jcls = getattr(jsched, cls.__name__)
    noise = _rand(39, (B, 1, HW, HW))
    key = jax.random.PRNGKey(11)
    want, _ = jcmp.sample_with(jcls, kwargs, 4, JSMOOTH, jnp.asarray(noise), key)
    if name == "DDPM":
        sch = cls(num_train_timesteps=1000)
        sch.set_timesteps(4)
        from generativemodels_tpu_torch.inferers import DiffusionInferer

        got = DiffusionInferer(sch).sample(torch.from_numpy(noise), TSMOOTH, step_noise=torch.stack(
            _key_draws(key, *[noise.shape] * 4)))
    else:
        got, secs = compare_schedulers.sample_with(cls, kwargs, 4, TSMOOTH,
                                                   torch.from_numpy(noise))
        assert secs > 0
    _close(got, want, CHAIN_RTOL)


def test_recipe_mains_run_tiny(tmp_path):
    cn = train_controlnet.main(["--pretrain-steps", "2", "--steps", "2", "--batch", "2",
                                "--size", "16", "--channels", "8", "8", "--norm-groups", "8",
                                "--device", "cpu"])
    assert len(cn["losses"]) == 2 and cn["state"].step == 2
    assert not any(p.requires_grad for p in cn["unet"].parameters())
    seg = segmentation_ddpm.main(["--steps", "2", "--batch", "2", "--size", "16",
                                  "--ensemble", "2", "--device", "cpu"])
    assert len(seg["losses"]) == 2 and all(np.isfinite(seg["losses"]))
    out = tmp_path / "cmp.json"
    records = compare_schedulers.main(
        ["--train-steps", "2", "--batch", "2", "--size", "16", "--sample-batch", "2",
         "--step-counts", "2", "--channels", "8", "8", "--norm-groups", "8",
         "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == records
    assert [(r["scheduler"], r["steps"]) for r in records] == [("DDPM", 1000)] + [
        (name, 2) for name, _, _ in compare_schedulers.SCHEDULERS]
