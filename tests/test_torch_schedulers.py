"""The port's schedulers against the JAX schedulers, on shared numpy inputs.

Tables and timestep plans are compared at atol 1e-6 (f32; the cumulative
products differ by at most a few f32 ulps between the two frameworks).
Steps compare at atol 1e-6 plus rtol 1e-5: a step divides by
sqrt(alpha_bar_t), which at late timesteps magnifies those ulps of the
tables by up to ~1e2 on unit-scale samples.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu_torch.networks import schedulers as tsched
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCHEDULES = ["linear_beta", "scaled_linear_beta", "sigmoid_beta", "cosine"]
ATOL = 1e-6
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
SHAPE = (2, 1, 8, 8)


def _rand(seed, shape=SHAPE):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or dict(atol=ATOL, rtol=0)))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_tables(schedule):
    j = jsched.Scheduler(1000, schedule)
    t = tsched.Scheduler(1000, schedule)
    for name in ("betas", "alphas", "alphas_cumprod"):
        _close(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_add_noise_and_velocity(schedule):
    j = jsched.Scheduler(1000, schedule)
    t = tsched.Scheduler(1000, schedule)
    x0, noise = _rand(0), _rand(1)
    steps = np.array([0, 999], dtype=np.int32)
    _close(
        t.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(steps).long()),
        j.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(steps)),
    )
    _close(
        t.get_velocity(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(steps).long()),
        j.get_velocity(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(steps)),
    )


@pytest.mark.parametrize("n", [10, 50, 1000])
def test_timesteps(n):
    jd, td = jsched.DDPMScheduler(), tsched.DDPMScheduler()
    jd.set_timesteps(n)
    td.set_timesteps(n)
    np.testing.assert_array_equal(td.timesteps.numpy(), jd.timesteps)
    ji, ti = jsched.DDIMScheduler(steps_offset=1), tsched.DDIMScheduler(steps_offset=1)
    ji.set_timesteps(n)
    ti.set_timesteps(n)
    np.testing.assert_array_equal(ti.timesteps.numpy(), ji.timesteps)


@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_large"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("timestep", [0, 500, 999])
def test_ddpm_step_with_injected_noise(variance_type, prediction_type, timestep):
    kw = dict(variance_type=variance_type, prediction_type=prediction_type)
    j, t = jsched.DDPMScheduler(**kw), tsched.DDPMScheduler(**kw)
    out, sample = _rand(2), _rand(3)
    key = jax.random.PRNGKey(timestep)
    noise = np.asarray(jax.random.normal(key, SHAPE, dtype=jnp.float32))
    j_prev, j_x0 = j.step(jnp.asarray(out), timestep, jnp.asarray(sample), key=key)
    t_prev, t_x0 = t.step(
        torch.from_numpy(out), timestep, torch.from_numpy(sample), noise=torch.from_numpy(noise)
    )
    _close(t_prev, j_prev, **STEP_TOL)
    _close(t_x0, j_x0, **STEP_TOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("timestep", [0, 500, 980])
def test_ddim_step_and_reversed_step(prediction_type, timestep):
    j = jsched.DDIMScheduler(prediction_type=prediction_type)
    t = tsched.DDIMScheduler(prediction_type=prediction_type)
    j.set_timesteps(50)
    t.set_timesteps(50)
    out, sample = _rand(4), _rand(5)
    for jr, tr in zip(
        j.step(jnp.asarray(out), timestep, jnp.asarray(sample)),
        t.step(torch.from_numpy(out), timestep, torch.from_numpy(sample)),
    ):
        _close(tr, jr, **STEP_TOL)
    for jr, tr in zip(
        j.reversed_step(jnp.asarray(out), timestep, jnp.asarray(sample)),
        t.reversed_step(torch.from_numpy(out), timestep, torch.from_numpy(sample)),
    ):
        _close(tr, jr, **STEP_TOL)


def test_ddim_step_eta_with_injected_noise():
    j, t = jsched.DDIMScheduler(), tsched.DDIMScheduler()
    j.set_timesteps(20)
    t.set_timesteps(20)
    out, sample = _rand(6), _rand(7)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, SHAPE, dtype=jnp.float32))
    j_prev, _ = j.step(jnp.asarray(out), 500, jnp.asarray(sample), eta=0.5, key=key)
    t_prev, _ = t.step(
        torch.from_numpy(out), 500, torch.from_numpy(sample), eta=0.5,
        noise=torch.from_numpy(noise),
    )
    _close(t_prev, j_prev, **STEP_TOL)
    with pytest.raises(ValueError):
        t.step(torch.from_numpy(out), 500, torch.from_numpy(sample), eta=0.5)


def test_step_takes_a_device_timestep_tensor():
    """The sampling loop passes 0-d timestep tensors; no host conversion."""
    t = tsched.DDIMScheduler()
    t.set_timesteps(10)
    out, sample = torch.from_numpy(_rand(8)), torch.from_numpy(_rand(9))
    for ts in t.timesteps[:3]:
        a, _ = t.step(out, ts, sample)
        b, _ = t.step(out, int(ts), sample)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [10, 50])
@pytest.mark.parametrize("skip_prk", [False, True], ids=["prk", "plms_only"])
def test_pndm_plan(n, skip_prk):
    kw = dict(skip_prk_steps=skip_prk, steps_offset=1)
    j, t = jsched.PNDMScheduler(**kw), tsched.PNDMScheduler(**kw)
    j.set_timesteps(n)
    t.set_timesteps(n)
    np.testing.assert_array_equal(t.timesteps.numpy(), j.timesteps)
    np.testing.assert_array_equal(t.prk_timesteps, j.prk_timesteps)
    assert t.num_inference_steps == j.num_inference_steps


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("skip_prk", [False, True], ids=["prk", "plms_only"])
@pytest.mark.parametrize("set_alpha_to_one", [False, True])
def test_pndm_chain_matches_jax(prediction_type, skip_prk, set_alpha_to_one):
    """Every step of a 10-step plan (19 with the RK warm-up), each from the
    JAX chain's own sample, with a model output drawn from a seed per step:
    the RK stages, the PLMS warm-up's redo and every multistep order. Held
    to 1e-5 of the step's largest value: formula (9) subtracts terms of
    order |sample| / sqrt(alpha_bar_t) (the random outputs drive samples to
    ~100), so the tables' ulps show in absolute terms on small elements."""
    kw = dict(skip_prk_steps=skip_prk, set_alpha_to_one=set_alpha_to_one,
              prediction_type=prediction_type)
    j, t = jsched.PNDMScheduler(**kw), tsched.PNDMScheduler(**kw)
    j.set_timesteps(10)
    t.set_timesteps(10)
    j_state = j.init_state(SHAPE)
    t_state = t.init_state(SHAPE)
    sample = _rand(10)
    for i, step in enumerate(j.timesteps):
        out = _rand(20 + i)
        j_prev, j_state = j.step(j_state, jnp.asarray(out), int(step), jnp.asarray(sample))
        t_prev, t_state = t.step(t_state, torch.from_numpy(out), t.timesteps[i],
                                 torch.from_numpy(sample.copy()))
        j_prev = np.asarray(j_prev)
        assert np.abs(t_prev.numpy() - j_prev).max() <= 1e-5 * np.abs(j_prev).max()
        assert t_state.counter == int(j_state.counter) == i + 1
        assert len(t_state.ets) == int(j_state.ets_count)
        sample = j_prev


def test_pndm_state_is_not_changed_by_a_step():
    t = tsched.PNDMScheduler()
    t.set_timesteps(10)
    state = t.init_state(SHAPE)
    out, sample = torch.from_numpy(_rand(1)), torch.from_numpy(_rand(2))
    a, _ = t.step(state, out, t.timesteps[0], sample)
    b, _ = t.step(state, out, t.timesteps[0], sample)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert state.counter == 0 and state.ets == ()


_DEVICE_SCHEDULERS = {
    "ddpm": (jsched.DDPMScheduler, tsched.DDPMScheduler),
    "ddim": (jsched.DDIMScheduler, tsched.DDIMScheduler),
    "dpmsolver": (jsched.DPMSolverMultistepScheduler, tsched.DPMSolverMultistepScheduler),
    "pndm": (jsched.PNDMScheduler, tsched.PNDMScheduler),
}


@pytest.mark.parametrize("name", sorted(_DEVICE_SCHEDULERS))
def test_set_timesteps_takes_a_device(name):
    """`set_timesteps(n, device=)`, the signature the JAX schedulers share:
    the plan equals JAX's (exactly), the plan and every table end on the
    named device, and a step gathers from them there."""
    jcls, tcls = _DEVICE_SCHEDULERS[name]
    j, t = jcls(num_train_timesteps=100), tcls(num_train_timesteps=100)
    j.set_timesteps(10, device="cpu")
    t.set_timesteps(10, device="cpu")
    np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))
    assert t.device == torch.device("cpu")
    tensors = [v for v in vars(t).values() if isinstance(v, torch.Tensor)]
    assert tensors and all(v.device == t.device for v in tensors)
    x, eps = torch.from_numpy(_rand(3)), torch.from_numpy(_rand(4))
    if name in ("dpmsolver", "pndm"):
        state = t.init_state(x.shape)
        out, _ = t.step(state, eps, t.timesteps[0], x)
    else:
        out, _ = t.step(eps, t.timesteps[0], x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_set_timesteps_without_a_device_keeps_the_device():
    t = tsched.DDIMScheduler(num_train_timesteps=100, device="cpu")
    t.set_timesteps(10)
    assert t.device == torch.device("cpu") and t.timesteps.device == t.device
