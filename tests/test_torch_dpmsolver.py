"""The port's DPM-Solver++ scheduler against the JAX one, on shared numpy inputs.

Plans: the port's own alpha-bar table differs from JAX's by a few f32 ulps
(test_torch_schedulers.py), and the plan's sigma = sqrt(1 - alpha_bar)
magnifies that near alpha_bar = 1 (up to 2.7e-4 relative in the lookback
weight of a 50-step plan, whose h increments there come from differences
of nearly equal log-SNRs). So
the plan is checked twice: from JAX's alpha-bar table, where both compute
the same float64 plan and the tables must be equal to the bit; and from
the port's own table, where timesteps must be equal and the tables agree
to rtol 1e-3. Steps compare at atol 1e-6 plus rtol 1e-5, as the DDIM steps
of test_torch_schedulers.py (a step divides by sqrt(alpha_bar_t)).
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

OWN_TABLE_TOL = dict(atol=1e-6, rtol=1e-3)
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
SHAPE = (2, 1, 8, 8)
TABLES = ("_c_x", "_c_d", "_c_n", "_c2")


def _rand(seed, shape=SHAPE):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _pair(n_steps, **kw):
    j = jsched.DPMSolverMultistepScheduler(**kw)
    t = tsched.DPMSolverMultistepScheduler(**kw)
    j.set_timesteps(n_steps)
    t.set_timesteps(n_steps)
    return j, t


@pytest.mark.parametrize("n_steps", [10, 25, 50])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("spacing", ["uniform_lambda", "leading"])
@pytest.mark.parametrize("algorithm", ["dpmsolver++", "sde-dpmsolver++"])
def test_plan_and_tables_match_jax(n_steps, order, spacing, algorithm):
    kw = dict(solver_order=order, timestep_spacing=spacing, algorithm_type=algorithm)
    j, own = _pair(n_steps, **kw)
    t = tsched.DPMSolverMultistepScheduler(**kw)
    t.alphas_cumprod = torch.from_numpy(np.array(j.alphas_cumprod))
    t.set_timesteps(n_steps)
    for port, exact in ((t, True), (own, False)):
        assert port.num_inference_steps == j.num_inference_steps
        np.testing.assert_array_equal(port.timesteps.numpy(), j.timesteps)
        assert port.timesteps.dtype == torch.long and port.timesteps.device == port.device
        for name in TABLES:
            got, want = getattr(port, name), np.asarray(getattr(j, name))
            assert got.dtype == torch.float32 and got.shape == want.shape
            if exact:
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, **OWN_TABLE_TOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
def test_steps_match_jax(prediction_type):
    """Three chained steps (the second and third use the order-2 lookback)."""
    j, t = _pair(10, prediction_type=prediction_type)
    sample = _rand(0)
    j_state = j.init_state(SHAPE)
    t_state = t.init_state(SHAPE)
    j_x, t_x = jnp.asarray(sample), torch.from_numpy(sample)
    for i in range(3):
        out = _rand(10 + i)
        j_x, j_state = j.step(j_state, jnp.asarray(out), j.timesteps[i], j_x)
        t_x, t_state = t.step(t_state, torch.from_numpy(out), t.timesteps[i], t_x)
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), **STEP_TOL)
        np.testing.assert_allclose(t_state.prev_x0.numpy(), np.asarray(j_state.prev_x0),
                                   **STEP_TOL)
        assert t_state.counter == i + 1


def test_sde_step_noise_comes_from_the_generator():
    """The SDE step is JAX's deterministic part plus c_n times a normal draw
    from the state's generator; each framework's draw is reproduced by hand."""
    j, t = _pair(10, algorithm_type="sde-dpmsolver++")
    sample, out = _rand(1), _rand(2)
    key = jax.random.PRNGKey(5)
    j_prev, _ = j.step(j.init_state(SHAPE, key=key), jnp.asarray(out), j.timesteps[0],
                       jnp.asarray(sample))
    j_noise = jax.random.normal(jax.random.split(key)[1], SHAPE, jnp.float32)
    gen = torch.Generator().manual_seed(11)
    clone = torch.Generator().manual_seed(11)
    state = t.init_state(SHAPE, generator=gen)
    t_prev, new_state = t.step(state, torch.from_numpy(out), t.timesteps[0],
                               torch.from_numpy(sample))
    t_noise = torch.randn(SHAPE, generator=clone)
    c_n = float(t._c_n[0])
    assert c_n > 0.1 and new_state.generator is gen
    np.testing.assert_allclose(
        (t_prev - c_n * t_noise).numpy(), np.asarray(j_prev - c_n * j_noise), **STEP_TOL
    )
    # the generator advanced: the next draw differs from the first
    assert not torch.equal(torch.randn(SHAPE, generator=gen), t_noise)


def test_sde_without_generator_warns():
    t = tsched.DPMSolverMultistepScheduler(algorithm_type="sde-dpmsolver++")
    with pytest.warns(UserWarning, match="SAME"):
        state = t.init_state(SHAPE)
    assert isinstance(state.generator, torch.Generator)


def test_order_one_leading_equals_ddim():
    """Order 1 on the "leading" grid is deterministic DDIM (eta = 0)."""
    t = tsched.DPMSolverMultistepScheduler(
        solver_order=1, timestep_spacing="leading", clip_sample=False
    )
    d = tsched.DDIMScheduler(clip_sample=False)
    t.set_timesteps(20)
    d.set_timesteps(20)
    torch.testing.assert_close(t.timesteps, d.timesteps, rtol=0, atol=0)
    x_t = x_d = torch.from_numpy(_rand(3))
    state = t.init_state(SHAPE)
    for i, ts in enumerate(t.timesteps):
        out = torch.from_numpy(_rand(20 + i))
        x_t, state = t.step(state, out, ts, x_t)
        x_d, _ = d.step(out, ts, x_d)
        torch.testing.assert_close(x_t, x_d, atol=1e-5, rtol=1e-5)


def test_bad_arguments_raise():
    for kw in (dict(solver_order=3), dict(prediction_type="x"), dict(algorithm_type="x"),
               dict(timestep_spacing="x"), dict(clip_sample_min=1.0)):
        with pytest.raises(ValueError):
            tsched.DPMSolverMultistepScheduler(**kw)
    with pytest.raises(ValueError):
        tsched.DPMSolverMultistepScheduler().set_timesteps(1001)
