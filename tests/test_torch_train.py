"""The port's training slice against the JAX package: UNet gradients, the
bf16 forward, checkpointing, the DDPM train step, EMA and the recipe.

Models are test_torch_unet.py's TINY UNet ((32, 64, 64), attention on
levels 1 and 2, 16x16 input, batch 2) with every parameter drawn from a
numpy seed and carried to the port by `unet_state_dict_from_jax`; JAX
gradients and params come back through the same converter. Tolerances:
- gradients (f32): rtol 1e-4 and atol 1e-4 of each parameter's largest
  gradient (summation order of the two frameworks' convolutions, GroupNorm
  statistics and attention), with a floor of 1e-6: the gradient of the
  attention's to_k bias is zero in exact arithmetic (softmax ignores a
  shift shared by all keys) and both frameworks leave ~3e-7 of rounding;
- the bf16 forward: 3e-2 of the largest output. Both compute in bf16 and
  round at other places (flax rounds each elementwise op and the linear
  layers' product before their bias);
- 3 train steps: losses at rtol 1e-4; parameters at atol 1e-6 + rtol 1e-4.
  Adam runs with eps 1e-3 on both sides (lr 1e-4): at the default 1e-8 its
  first steps move a parameter by lr * sign(grad), so the rounding noise of
  a gradient that is zero in exact arithmetic (the to_k biases) becomes a
  full step of random sign.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu.networks.schedulers import DDPMScheduler as JaxDDPM
from generativemodels_tpu.parallel import train as jtrain
from generativemodels_tpu_torch.networks import unet_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from generativemodels_tpu_torch.parallel import (
    TrainState,
    init_train_state,
    make_diffusion_train_step,
    make_multi_step_train,
)
from generativemodels_tpu_torch.parallel.train import _ema_update
from generativemodels_tpu_torch.recipes import train_2d_ddpm

from .test_torch_unet import BATCH, SPATIAL, TINY, build_pair, inputs
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6
BF16_REL = 3e-2
LR, EPS = 1e-4, 1e-3


def _to_port_layout(tree, port) -> dict[str, np.ndarray]:
    """A JAX params-shaped tree (params or grads) in the port's state-dict layout."""
    return {k: v.numpy() for k, v in unet_state_dict_from_jax(tree, port.state_dict()).items()}


def _assert_grads_close(got: dict, want: dict, tol: float) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=tol, atol=max(tol * np.abs(w).max(), GRAD_FLOOR), err_msg=name
        )


def _port_grads(port, x, t, g) -> dict[str, np.ndarray]:
    port.zero_grad(set_to_none=True)
    out = port(torch.from_numpy(x), torch.from_numpy(t))
    (out * torch.from_numpy(g)).sum().backward()
    return {name: p.grad.numpy().copy() for name, p in port.named_parameters()}


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_unet_gradients_match_jax(use_flash):
    """use_flash_attention=True: JAX differentiates its Pallas kernels in
    interpret mode; the port runs its autograd Function's plain backward."""
    jmodel, params, port = build_pair(seed=5, use_flash_attention=use_flash)
    x, t = inputs(6)
    g = np.random.RandomState(7).standard_normal(x.shape).astype(np.float32)

    def f(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t, dtype=jnp.int32))
        return jnp.sum(out * jnp.asarray(g))

    want = _to_port_layout(jax.grad(f)(params), port)
    _assert_grads_close(_port_grads(port, x, t, g), want, GRAD_TOL)


def test_bf16_forward_matches_jax():
    _, params, port = build_pair(seed=8, use_flash_attention=True)
    jmodel = JaxUNet(**TINY, use_flash_attention=True, dtype=jnp.bfloat16)
    port16 = DiffusionModelUNet(**TINY, use_flash_attention=True, dtype=torch.bfloat16)
    port16.load_state_dict(port.state_dict(), strict=True)
    x, t = inputs(9)
    want = np.asarray(
        jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, dtype=jnp.int32))
    )
    with torch.no_grad():
        got = port16(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32  # output cast back, as in JAX
    assert all(p.dtype == torch.float32 for p in port16.parameters())  # params stay f32
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got.numpy() - want).max() <= BF16_REL * scale


@pytest.mark.parametrize("remat", [True, (True, False, True)], ids=["all", "per_level"])
def test_checkpointing_keeps_gradients(remat):
    _, _, port = build_pair(seed=10, use_flash_attention=True)
    ckpt = DiffusionModelUNet(**TINY, use_flash_attention=True, use_checkpointing=remat)
    ckpt.load_state_dict(port.state_dict(), strict=True)
    x, t = inputs(11)
    g = np.random.RandomState(12).standard_normal(x.shape).astype(np.float32)
    want = _port_grads(port, x, t, g)
    got = _port_grads(ckpt, x, t, g)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_checkpointing_sequence_length_is_checked():
    with pytest.raises(ValueError, match="one entry per level"):
        DiffusionModelUNet(**TINY, use_checkpointing=(True, False))


def _jax_draws(rng, images, T=1000):
    """The noise and timesteps the JAX step draws from `rng` (train.py:93-95)."""
    k_noise, k_t = jax.random.split(rng)
    noise = jax.random.normal(k_noise, images.shape, dtype=images.dtype)
    timesteps = jax.random.randint(k_t, (images.shape[0],), 0, T)
    return np.array(noise), np.asarray(timesteps).astype(np.int64)


@pytest.mark.parametrize("target", ["epsilon", "v_prediction"])
def test_train_step_matches_jax(target):
    jmodel, params, port = build_pair(seed=13, use_flash_attention=False)
    port.train()
    images = np.random.RandomState(14).uniform(-1, 1, (BATCH, 1, *SPATIAL)).astype(np.float32)

    tx = optax.adam(LR, eps=EPS)
    apply = lambda p, xx, tt: jmodel.apply({"params": p}, xx, tt)  # noqa: E731
    jstep = jtrain.make_diffusion_train_step(
        apply, JaxDDPM(num_train_timesteps=1000), tx, prediction_target=target, donate=False
    )
    jstate = jtrain.init_train_state(params, tx)
    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000),
                                     prediction_target=target)
    state = init_train_state(port, torch.optim.Adam(port.parameters(), lr=LR, eps=EPS))

    rng = jax.random.PRNGKey(15)
    for _ in range(3):
        rng, sub = jax.random.split(rng)
        jstate, jloss = jstep(jstate, jnp.asarray(images), sub)
        noise, timesteps = _jax_draws(sub, images)
        state, loss = step.update(
            state, torch.from_numpy(images), torch.from_numpy(noise), torch.from_numpy(timesteps)
        )
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert state.step == 3
    want = _to_port_layout(jax.device_get(jstate.params), port)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), want[name], rtol=1e-4, atol=1e-6, err_msg=name
        )


def _tiny_state(seed: int, ema: bool = False) -> TrainState:
    _, _, port = build_pair(seed=seed, use_flash_attention=False)
    optimizer = torch.optim.Adam(port.parameters(), lr=LR, eps=EPS)
    return init_train_state(port.train(), optimizer, ema=ema)


def _images(seed: int, n: int = BATCH) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (n, 1, *SPATIAL)).astype(np.float32))


def test_accumulated_step_equals_full_batch():
    images = _images(16, 4)
    rng = np.random.RandomState(17)
    noise = torch.from_numpy(rng.standard_normal(images.shape).astype(np.float32))
    timesteps = torch.from_numpy(rng.randint(0, 1000, 4))
    sched = DDPMScheduler(num_train_timesteps=1000)
    full, acc = _tiny_state(18), _tiny_state(18)
    full, loss_full = make_diffusion_train_step(sched).update(full, images, noise, timesteps)
    acc, loss_acc = make_diffusion_train_step(sched, accumulate_steps=2).update(
        acc, images, noise, timesteps
    )
    np.testing.assert_allclose(loss_acc.item(), loss_full.item(), rtol=1e-6)
    for (name, a), b in zip(acc.model.named_parameters(), full.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=name)

    with pytest.raises(ValueError, match="not divisible"):
        make_diffusion_train_step(sched, accumulate_steps=3).update(
            _tiny_state(18), images, noise, timesteps
        )


@pytest.mark.parametrize("step_count", [0, 5, 10_000])
def test_ema_update_matches_jax(step_count):
    rng = np.random.RandomState(19)
    model = torch.nn.Linear(3, 4)
    ema = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
           for n, p in model.named_parameters()}
    want_tree = jtrain._ema_update(
        jtrain.TrainState(None, None, jnp.asarray(step_count),
                          {n: jnp.asarray(e.numpy()) for n, e in ema.items()}),
        {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()},
        0.999,
    )
    state = TrainState(model, None, step_count, ema)
    got = _ema_update(state, 0.999)
    for n, w in want_tree.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_ema_tracks_in_step_and_requires_init():
    sched = DDPMScheduler(num_train_timesteps=1000)
    state = _tiny_state(20, ema=True)
    before = {n: e.clone() for n, e in state.ema_params.items()}
    state, _ = make_diffusion_train_step(sched, ema_decay=0.9)(
        state, _images(21), torch.Generator().manual_seed(0)
    )
    # step 0: decay min(0.9, 1/10) = 0.1, so the average moves 90% of the way
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(
            state.ema_params[n], before[n] * 0.1 + p.detach() * 0.9, rtol=1e-5, atol=1e-6
        )
    with pytest.raises(ValueError, match="ema_params is None"):
        make_diffusion_train_step(sched, ema_decay=0.9)(
            _tiny_state(20), _images(21), torch.Generator().manual_seed(0)
        )


def test_multi_step_train_matches_single_steps():
    sched = DDPMScheduler(num_train_timesteps=1000)
    stacked = torch.stack([_images(22), _images(23)])
    multi, single = _tiny_state(24), _tiny_state(24)
    multi, losses = make_multi_step_train(sched, steps_per_call=2)(
        multi, stacked, torch.Generator().manual_seed(3)
    )
    step = make_diffusion_train_step(sched)
    g = torch.Generator().manual_seed(3)
    want = []
    for images in stacked:
        single, loss = step(single, images, g)
        want.append(loss)
    assert losses.shape == (2,) and multi.step == single.step == 2
    torch.testing.assert_close(losses, torch.stack(want), rtol=0, atol=0)
    for a, b in zip(multi.model.parameters(), single.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sharded_training_is_not_ported():
    """(The name predates the mesh step, tests/test_torch_parallel.py.) A
    mesh must be the port's, and a spatial cut needs one."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        make_diffusion_train_step(DDPMScheduler(), mesh=object())
    with pytest.raises(ValueError, match="needs a mesh"):
        make_diffusion_train_step(DDPMScheduler(), spatial_shard_axis=2)


def test_recipe_main_trains_on_cpu():
    out = train_2d_ddpm.main([
        "--steps", "2", "--batch", "2", "--size", "16", "--channels", "16", "32",
        "--norm-groups", "8", "--device", "cpu", "--ema-decay", "0.99",
    ])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert out["state"].step == 2 and out["state"].ema_params is not None
    images = train_2d_ddpm.synthetic_batch(torch.Generator().manual_seed(0), 3, 16)
    assert images.shape == (3, 1, 16, 16)
    assert float(images.min()) >= 0.0 and float(images.max()) <= 1.0
