"""The port's checkpoints, NaN guard and metrics logger, against the JAX
package's where both run on the CPU.

The guard is held against the JAX guard on one sequence of steps with
finite and non-finite losses: the same parameters after every step (equal
to the bit: one f32 multiply-subtract each) and the same count of skipped
steps. On a real training step (the port's diffusion step on a small UNet,
Adam) a NaN batch leaves every parameter and the optimizer's state as they
were. The logger's JSONL records equal the JAX logger's but for the clock.
"""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.utils import guards as jax_guards
from generativemodels_tpu.utils import logging as jax_logging
from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from generativemodels_tpu_torch.parallel import init_train_state, make_diffusion_train_step
from generativemodels_tpu_torch.utils import (
    CheckpointManager,
    GuardState,
    MetricsLogger,
    guard_nans,
    init_guard,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_save_restore_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": [torch.ones(2, 3, dtype=torch.float64)], "step": 7}
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.save(0, state)
    raw = mgr.restore()
    torch.testing.assert_close(raw["params"]["w"], state["params"]["w"], rtol=0, atol=0)
    assert raw["step"] == 7
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64)},
                "opt": [torch.zeros(2, 3)], "step": 0}
    restored = mgr.restore(0, template=template)
    assert restored["params"]["w"].dtype == torch.float64
    assert restored["opt"][0].dtype == torch.float32 and restored["step"] == 7
    assert [p for p in os.listdir(tmp_path) if not p.endswith(".pt")] == []
    mgr.close()


def test_modules_and_optimizers_restore_in_place(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"model": model, "opt": opt, "step": 1})
    fresh = torch.nn.Linear(3, 2)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=0.1)
    out = mgr.restore(template={"model": fresh, "opt": fresh_opt, "step": 0})
    assert out["model"] is fresh and out["step"] == 1
    for a, b in zip(fresh.parameters(), model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    exp_avg = opt.state[next(iter(model.parameters()))]["exp_avg"]
    torch.testing.assert_close(fresh_opt.state[next(iter(fresh.parameters()))]["exp_avg"],
                               exp_avg, rtol=0, atol=0)


def test_retention_and_step_order(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for i in range(4):
        assert mgr.save(i, {"x": torch.full((2,), float(i))})
    assert mgr.latest_step() == 3 and mgr.all_steps() == [2, 3]
    # as orbax: a step not past the latest is skipped unless forced
    assert not mgr.save(3, {"x": torch.zeros(2)})
    assert float(mgr.restore()["x"][0]) == 3.0
    assert mgr.save(3, {"x": torch.zeros(2)}, force=True)
    assert float(mgr.restore()["x"][0]) == 0.0


def test_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore()


def test_guard_matches_jax():
    xs = [np.array([1.0, 2.0], np.float32), np.array([np.nan, 1.0], np.float32),
          np.array([0.5, -1.0], np.float32), np.array([np.inf, 0.0], np.float32),
          np.array([3.0, 1.0], np.float32)]

    def jax_step(state, x):
        return {"w": state["w"] - 0.1 * x}, jnp.sum(x)

    def port_step(state, x):
        state["w"].sub_(0.1 * x)
        return state, torch.sum(x)

    jax_state = jax_guards.init_guard({"w": jnp.ones(2)})
    port_state = init_guard({"w": torch.ones(2)})
    jax_fn, port_fn = jax_guards.guard_nans(jax_step), guard_nans(port_step)
    for x in xs:
        jax_state, _ = jax_fn(jax_state, jnp.asarray(x))
        port_state, _ = port_fn(port_state, torch.from_numpy(x))
        np.testing.assert_array_equal(port_state.inner["w"].numpy(),
                                      np.asarray(jax_state.inner["w"]))
        assert port_state.skipped == int(jax_state.skipped)
    assert port_state.skipped == 2


def test_guard_keeps_a_training_step_from_a_nan_batch():
    torch.manual_seed(0)
    model = DiffusionModelUNet(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
                               num_channels=(8, 8), attention_levels=(False, True),
                               num_head_channels=8, norm_num_groups=8)
    step = guard_nans(make_diffusion_train_step(DDPMScheduler(num_train_timesteps=100)))
    gstate = init_guard(init_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-2)))
    g = torch.Generator().manual_seed(1)
    images = torch.rand((2, 1, 16, 16), generator=g)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gstate, loss = step(gstate, torch.full_like(images, float("nan")), g)
    assert not torch.isfinite(loss) and gstate.skipped == 1 and gstate.inner.step == 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert len(gstate.inner.optimizer.state) == 0  # the first step's moments are dropped
    gstate, loss = step(gstate, images, g)
    assert torch.isfinite(loss) and gstate.skipped == 1 and gstate.inner.step == 1
    assert isinstance(gstate, GuardState)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
    assert moved


def test_logger_records_match_jax(tmp_path):
    metrics = {"loss": torch.tensor(0.25), "lr": 1e-4, "note": "warm-up", "n": np.int64(3)}
    jax_metrics = dict(metrics, loss=jnp.asarray(0.25))
    ours = MetricsLogger(str(tmp_path / "port"), use_tensorboard=False)
    theirs = jax_logging.MetricsLogger(str(tmp_path / "jax"), use_tensorboard=False)
    for step in range(3):
        ours.log(step, metrics)
        theirs.log(step, jax_metrics)
    ours.close()
    theirs.close()

    def records(path):
        with open(path) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]

    assert records(ours.path) == records(theirs.path)
    assert records(ours.path)[1] == {"step": 1, "loss": 0.25, "lr": 1e-4, "note": "warm-up",
                                     "n": 3.0}


def test_logger_writes_tensorboard_events_where_it_imports(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    logger = MetricsLogger(str(tmp_path))
    logger.log(0, {"loss": 1.5})
    logger.close()
    assert any(name.startswith("events.out.tfevents") for name in os.listdir(tmp_path))
