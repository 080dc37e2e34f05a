"""The port's stage-1 recipes (train_vqgan, train_2d_ldm, train_3d_ldm)
against the JAX recipes.

- Each recipe's `main` runs end to end with `--device cpu` at a tiny size
  (full model widths, 32-pixel images or volumes, a few steps) and gives
  finite losses of the expected count.
- The 3D recipe's stage-1 step (its AutoencoderKL with an attention level
  and its instance-norm PatchGAN, narrowed) and its stage-2 step (the latent
  UNet through LatentDiffusionInferer, the AEKL's encode a constant) are
  held against the JAX steps on the same weights and batch, the port's draws
  (latent noise; stage 2's noise, timesteps and latent noise) replayed into
  the JAX side: losses at rtol 1e-4, parameters at atol 1e-6 + rtol 1e-4,
  Adam with eps 1e-3 on both sides (tests/test_torch_adversarial.py says
  why).
- `compute_scale_factor` (the population std, as jnp.std) at rtol 1e-6.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativemodels_tpu import engines as jengines
from generativemodels_tpu.inferers import LatentDiffusionInferer as JaxLatentInferer
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import AutoencoderKL as JaxAEKL
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu.networks.nets import PatchDiscriminator as JaxPatch
from generativemodels_tpu.networks.schedulers import DDPMScheduler as JaxDDPM
from generativemodels_tpu.recipes.super_resolution import (
    compute_scale_factor as jax_scale_factor,
)
from generativemodels_tpu_torch import engines
from generativemodels_tpu_torch.inferers import LatentDiffusionInferer
from generativemodels_tpu_torch.networks import (
    autoencoderkl_state_dict_from_jax,
    patchgan_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import (
    AutoencoderKL,
    DiffusionModelUNet,
    PatchDiscriminator,
)
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from generativemodels_tpu_torch.recipes import train_2d_ldm, train_3d_ldm, train_vqgan
from tests.test_torch_adversarial import (
    EPS,
    LR,
    STATE_ATOL,
    STEP_RTOL,
    jax_stage1_step,
    run_stage1_pair,
)
from tests.test_torch_unet import random_params
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BATCH = 2
SIZE = 16
AEKL3 = dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
             num_channels=(8, 16), attention_levels=(False, True), latent_channels=3,
             norm_num_groups=4, with_encoder_nonlocal_attn=False,
             with_decoder_nonlocal_attn=False)
DISC3 = dict(spatial_dims=3, num_channels=8, in_channels=1, num_layers_d=2, norm="INSTANCE")
UNET3 = dict(spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=1,
             num_channels=(8, 16), attention_levels=(False, True), num_head_channels=8,
             norm_num_groups=4)


@pytest.mark.parametrize("recipe, argv", [
    (train_vqgan, ["--steps", "3", "--warmup-steps", "1", "--batch", "2", "--size", "32"]),
    (train_2d_ldm, ["--stage1-steps", "3", "--warmup-steps", "1", "--stage2-steps", "2",
                    "--batch", "2", "--size", "32"]),
    (train_3d_ldm, ["--stage1-steps", "2", "--warmup-steps", "1", "--stage2-steps", "2",
                    "--batch", "1", "--size", "32", "--sample", "--sample-steps", "2"]),
], ids=["vqgan", "2d_ldm", "3d_ldm"])
def test_recipe_main_runs_on_cpu(recipe, argv):
    result = recipe.main(argv + ["--device", "cpu"])
    if recipe is train_vqgan:
        assert len(result["outputs"]) == len(result["seconds"]) == 3
        assert all(np.isfinite(v) for out in result["outputs"] for v in out.values())
        assert 1 <= result["codebook_usage"] <= 256
        return
    stage1 = int(argv[1])
    assert len(result["stage1_losses"]) == len(result["stage1_seconds"]) == stage1
    assert len(result["stage2_losses"]) == 2
    assert all(np.isfinite(v) for out in result["stage1_losses"] for v in out.values())
    assert all(np.isfinite(result["stage2_losses"])) and result["scale_factor"] > 0
    assert result["state"].step == stage1
    if recipe is train_3d_ldm:
        sample = result["sample"]
        assert sample.shape == (1, 1, 32, 32, 32) and bool(torch.isfinite(sample).all())


def test_recipe_models_are_the_jax_recipes():
    """The full-width models have the JAX recipes' parameters, key by key
    (each JAX params tree maps onto the port's state dict by the converters)."""
    aekl, disc, unet = train_3d_ldm.build_models()
    x = jnp.zeros((1, 1, 32, 32, 32))
    jaekl = JaxAEKL(spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
                    num_channels=(32, 64, 64), attention_levels=(False, False, True),
                    latent_channels=3, norm_num_groups=16, with_encoder_nonlocal_attn=False,
                    with_decoder_nonlocal_attn=False)
    struct = zoo_convert.params_structure(jaekl, x, method=JaxAEKL.reconstruct)
    autoencoderkl_state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), struct),
                                      aekl.state_dict(), (32, 64, 64), 1, (False, False, True),
                                      False, False)
    jdisc = JaxPatch(spatial_dims=3, num_channels=32, in_channels=1, num_layers_d=3,
                     norm="INSTANCE")
    struct = zoo_convert.params_structure(jdisc, x)
    patchgan_state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), struct),
                                 disc.state_dict())
    junet = JaxUNet(spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=1,
                    num_channels=(32, 64, 64), attention_levels=(False, True, True),
                    num_head_channels=64, norm_num_groups=16)
    struct = zoo_convert.params_structure(junet, jnp.zeros((1, 3, 8, 8, 8)),
                                          jnp.zeros((1,), jnp.int32))
    unet_state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), struct),
                             unet.state_dict())


def _volumes(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(0, 1, (BATCH, 1) + (SIZE,) * 3).astype(
        np.float32)


def _aekl3(seed: int):
    jaekl = JaxAEKL(**AEKL3)
    struct = zoo_convert.params_structure(jaekl, jnp.zeros((BATCH, 1) + (SIZE,) * 3),
                                          method=JaxAEKL.reconstruct)
    params = random_params(struct, seed)
    port = AutoencoderKL(**AEKL3)
    port.load_state_dict(_aekl3_state(params, port), strict=True)
    return jaekl, params, port.train()


def _aekl3_state(params, port) -> dict:
    return autoencoderkl_state_dict_from_jax(params, port.state_dict(), (8, 16), 1,
                                             (False, True), False, False)


def _assert_params(port, want: dict, what: str) -> None:
    got = port.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=STEP_RTOL, atol=STATE_ATOL,
                                   err_msg=f"{what}: {key}")


def test_3d_stage1_steps_match_jax():
    """A warm-up step and an adversarial step of the 3D recipe's stage 1."""
    jaekl, g_params, aekl = _aekl3(0)
    jdisc = JaxPatch(**DISC3)
    d_params = random_params(zoo_convert.params_structure(
        jdisc, jnp.zeros((BATCH, 1) + (SIZE,) * 3)), 1)
    disc = PatchDiscriminator(**DISC3)
    disc.load_state_dict(patchgan_state_dict_from_jax(d_params, disc.state_dict()), strict=True)
    tx, j_warm = jax_stage1_step(jaekl, jdisc, 1e-2, 0.0, batch_stats=False)
    _, j_full = jax_stage1_step(jaekl, jdisc, 1e-2, 0.5, batch_stats=False)
    jstate = jengines.AdversarialTrainState(
        g_params=g_params, g_model_state={}, g_opt_state=tx.init(g_params),
        d_params=d_params, d_model_state={}, d_opt_state=tx.init(d_params), step=jnp.asarray(0))
    warm, full = train_2d_ldm.make_stage1_steps(1e-2, 0.5)
    state = engines.init_adversarial_state(
        aekl, torch.optim.Adam(aekl.parameters(), lr=LR, eps=EPS),
        disc.train(), torch.optim.Adam(disc.parameters(), lr=LR, eps=EPS))
    state, jstate = run_stage1_pair([warm, full], [j_warm, j_full], state, jstate,
                                    [_volumes(1), _volumes(2)], (BATCH, 3, 8, 8, 8))
    _assert_params(aekl, _aekl3_state(jstate.g_params, aekl), "G")
    _assert_params(disc, patchgan_state_dict_from_jax(jstate.d_params, disc.state_dict()), "D")


class _ReplayedStage1:
    """The JAX AEKL with its latent noise given: encode_stage_2_inputs is
    z_mu + eps * z_sigma."""

    def __init__(self, bound, eps) -> None:
        self.bound, self.eps = bound, eps

    def encode_stage_2_inputs(self, x, key=None):
        z_mu, z_sigma = self.bound.encode(x)
        return z_mu + self.eps * z_sigma

    def decode_stage_2_outputs(self, z):
        return self.bound.decode(z)


def test_3d_stage2_step_matches_jax():
    """One stage-2 update of the 3D recipe: the loss and the UNet's
    parameters after Adam."""
    jaekl, aekl_params, aekl = _aekl3(2)
    aekl.eval()
    junet = JaxUNet(**UNET3)
    latent = (BATCH, 3, 8, 8, 8)
    u_params = random_params(zoo_convert.params_structure(
        junet, jnp.zeros(latent), jnp.zeros((BATCH,), jnp.int32)), 3)
    unet = DiffusionModelUNet(**UNET3)
    unet.load_state_dict(unet_state_dict_from_jax(u_params, unet.state_dict()), strict=True)
    scale = 0.7
    images = _volumes(4)

    optimizer = torch.optim.Adam(unet.parameters(), lr=LR, eps=EPS)
    inferer = LatentDiffusionInferer(DDPMScheduler(num_train_timesteps=1000), scale_factor=scale)
    loss = train_2d_ldm.stage2_step(unet.train(), optimizer, aekl, inferer,
                                    torch.from_numpy(images), latent,
                                    torch.Generator().manual_seed(6))
    replay = torch.Generator().manual_seed(6)
    noise = torch.randn(latent, generator=replay).numpy()
    timesteps = torch.randint(0, 1000, (BATCH,), generator=replay).numpy()
    eps = torch.randn(latent, generator=replay).numpy()

    stage1 = _ReplayedStage1(jaekl.bind({"params": aekl_params}), jnp.asarray(eps))
    jinferer = JaxLatentInferer(JaxDDPM(num_train_timesteps=1000), scale_factor=scale)

    def loss_fn(p):
        pred = jinferer(jnp.asarray(images), stage1,
                        lambda x, t, context=None: junet.apply({"params": p}, x, t),
                        jnp.asarray(noise), jnp.asarray(timesteps))
        return jnp.mean((pred - jnp.asarray(noise)) ** 2)

    jloss, grads = jax.value_and_grad(loss_fn)(u_params)
    tx = optax.adam(LR, eps=EPS)
    updates, _ = tx.update(grads, tx.init(u_params), u_params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_RTOL)
    _assert_params(unet, unet_state_dict_from_jax(optax.apply_updates(u_params, updates),
                                                  unet.state_dict()), "UNet")
    assert all(p.grad is None for p in aekl.parameters())  # the encode is a constant


def test_compute_scale_factor_matches_jax():
    z = np.random.RandomState(8).standard_normal((2, 3, 4, 4, 4)).astype(np.float32) * 3.0
    np.testing.assert_allclose(float(train_2d_ldm.compute_scale_factor(torch.from_numpy(z))),
                               float(jax_scale_factor(jnp.asarray(z))), rtol=1e-6)
