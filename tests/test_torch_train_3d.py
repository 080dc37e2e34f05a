"""The port's 3D training slice against the JAX package: one DDPM train
step of a small 3D UNet, and the 3D recipe.

The UNet is 3D with channels (16, 32), attention on the last level (one
32-wide head, `use_flash_attention=True`), 8 groups, a 16^3 input at batch
2: the attention runs at 8^3 = 512 tokens through the flash branch and its
backward (on the JAX side the Pallas kernels in interpret mode; on the
port's, the autograd Function's plain versions). Every JAX parameter is
drawn from a numpy seed and carried to the port by
`unet_state_dict_from_jax`; both steps see the same images, noise and
timesteps (the JAX step's own draws). Three settings of the port's step:
f32; a per-level `use_checkpointing` that recomputes the attention level
(against the same JAX step: remat recomputes the same values); and
GMTPU_FLASH_FUSED_BWD=1, against a JAX step traced with it set (which runs
`_dfused_kernel`).
Tolerances are test_torch_train.py's: the loss at rtol 1e-4, the updated
parameters at rtol 1e-4 and atol 1e-6, with Adam's eps at 1e-3.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu.networks.schedulers import DDPMScheduler as JaxDDPM
from generativemodels_tpu.parallel import train as jtrain
from generativemodels_tpu.recipes.train_3d_ddpm import synthetic_volume as jax_volume
from generativemodels_tpu_torch.networks import unet_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from generativemodels_tpu_torch.parallel import init_train_state, make_diffusion_train_step
from generativemodels_tpu_torch.recipes import train_3d_ddpm

from .test_torch_train import EPS, LR, _jax_draws, _to_port_layout
from .test_torch_unet import random_params

SMALL_3D = dict(
    spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
    num_channels=(16, 32), attention_levels=(False, True), num_head_channels=32,
    norm_num_groups=8, use_flash_attention=True,
)
SIZE, BATCH = 16, 1

# name: (the port's use_checkpointing, GMTPU_FLASH_FUSED_BWD)
SETTINGS = {
    "f32": (False, "0"),
    "remat_per_level": ((False, True), "0"),
    "fused_bwd": (False, "1"),
}


@functools.lru_cache(maxsize=None)
def _jax_step(fused: str):
    """(params, images, noise, timesteps, loss, updated params) of one JAX
    step; the caller has set GMTPU_FLASH_FUSED_BWD to `fused`, which the JAX
    backward reads while the step traces. The remat setting shares the
    plain JAX step: `nn.remat` recomputes the same values, and each JAX
    trace of this model costs ~11 s of the suite's time on the CPU."""
    jmodel = JaxUNet(**SMALL_3D)
    x0 = jnp.zeros((BATCH, 1) + (SIZE,) * 3)
    struct = zoo_convert.params_structure(jmodel, x0, jnp.zeros((BATCH,), jnp.int32))
    params = random_params(struct, seed=31)
    images = np.asarray(jax_volume(jax.random.PRNGKey(32), BATCH, SIZE)) * 2 - 1
    tx = optax.adam(LR, eps=EPS)
    jstep = jtrain.make_diffusion_train_step(
        lambda p, xx, tt: jmodel.apply({"params": p}, xx, tt),
        JaxDDPM(num_train_timesteps=1000), tx, donate=False,
    )
    rng = jax.random.PRNGKey(33)
    jstate, jloss = jstep(jtrain.init_train_state(params, tx), jnp.asarray(images), rng)
    noise, timesteps = _jax_draws(rng, images)
    return params, images, noise, timesteps, float(jloss), jax.device_get(jstate.params)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_train_step_3d_matches_jax(name, monkeypatch):
    remat, fused = SETTINGS[name]
    # read by both backwards: JAX's at trace time, the port's at each backward
    monkeypatch.setenv("GMTPU_FLASH_FUSED_BWD", fused)
    params, images, noise, timesteps, jloss, jparams = _jax_step(fused)
    port = DiffusionModelUNet(**SMALL_3D, use_checkpointing=remat)
    port.load_state_dict(unet_state_dict_from_jax(params, port.state_dict()), strict=True)
    port.train()

    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000))
    state = init_train_state(port, torch.optim.Adam(port.parameters(), lr=LR, eps=EPS))
    state, loss = step.update(
        state, torch.from_numpy(images), torch.from_numpy(noise), torch.from_numpy(timesteps)
    )
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-4)
    want = _to_port_layout(jparams, port)
    start = _to_port_layout(params, port)
    for pname, p in port.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), want[pname], rtol=1e-4, atol=1e-6, err_msg=pname
        )
    assert any(not np.array_equal(want[n], start[n]) for n in want)  # the step moved them


def test_synthetic_volume_shape_range_and_seeding():
    def draw(seed):
        return train_3d_ddpm.synthetic_volume(torch.Generator().manual_seed(seed), 3, 12)

    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (3, 1, 12, 12, 12) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert float(a.max()) > 0.5  # a blob is there: its centre lies inside the volume
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_recipe_main_trains_and_samples_on_cpu():
    out = train_3d_ddpm.main([
        "--device", "cpu", "--steps", "2", "--batch", "1", "--size", "16",
        "--channels", "16", "32", "--norm-groups", "8", "--head-channels", "32",
        "--dtype", "f32", "--remat-levels", "0", "1", "--ema-decay", "0.99",
        "--sample", "--sample-steps", "2",
    ])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    state = out["state"]
    assert state.step == 2 and state.ema_params is not None
    assert state.model.use_checkpointing == (False, True)
    assert out["sample"].shape == (1, 1, 16, 16, 16)
    assert bool(torch.isfinite(out["sample"]).all())
