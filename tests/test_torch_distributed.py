"""The port across real processes, held against the JAX package
(tests/test_distributed.py's checks).

`spawn` (also used by tests/test_torch_parallel.py and
tests/test_torch_sharded_attention.py) starts a world of `gloo` ranks, one
process each, that import only torch, numpy and the port
(tests/torch_dist_workers.py), hands them pickled inputs made from numpy
seeds, and returns each rank's results to the pytest process, where the JAX
functions compute the references on one CPU device. The ranks of a spawn
share one 240 s deadline, and a rank that fails ends its world at once,
so a hang or a fault fails fast. One spawn here serves every check.

Tolerances:
- the train step: the loss within 1e-6 and the parameters' L1 norm within
  1e-6 relative, the JAX test's bounds (the JAX step on one device against
  the port's two-rank step, both in f32);
- DDIM sampling of each rank's rows: within 1e-5 of the JAX single-device
  sampler, the JAX test's bound;
- the codebook: 1e-5 relative (the JAX test_parallel bound).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from generativemodels_tpu.inferers import DiffusionInferer as JaxInferer
from generativemodels_tpu.networks.layers.vector_quantizer import EMAQuantizer as JaxEMA
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu.networks.schedulers import DDIMScheduler as JaxDDIM
from generativemodels_tpu.networks.schedulers import DDPMScheduler as JaxDDPM
from generativemodels_tpu.parallel import train as jtrain
from generativemodels_tpu_torch.networks import unet_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet

from .test_torch_unet import random_params
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
# one deadline for the whole world: a healthy spawn here takes 10-40 s
SPAWN_TIMEOUT = 240


def spawn(case: str, world: int, inputs: dict, tmp_path: Path,
          timeout: float = SPAWN_TIMEOUT) -> list[dict]:
    """Run `case` of tests/torch_dist_workers.py on `world` gloo ranks (one
    process each); returns their results in rank order.

    The ranks share one deadline. The first rank that fails ends the world
    at once (the others would wait in their next collective), and the error
    carries every rank's stderr; so does a world that outlives the
    deadline."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    in_path = tmp_path / f"{case}_inputs.pkl"
    in_path.write_bytes(pickle.dumps(inputs))
    store = tmp_path / f"{case}_store"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    logs = [tmp_path / f"{case}_err{rank}.txt" for rank in range(world)]
    procs = []
    for rank in range(world):
        with open(logs[rank], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_workers", case, str(rank), str(world),
                 str(store), str(in_path), str(tmp_path / f"{case}_out{rank}.pkl")],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err,
            ))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
            elif time.monotonic() > deadline:
                failed = f"the world of {world} outlived its {timeout:.0f} s deadline"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        tails = "\n".join(f"--- rank {rank} stderr:\n{log.read_text()[-3000:]}"
                          for rank, log in enumerate(logs))
        raise RuntimeError(f"{case}: {failed}\n{tails}")
    return [pickle.loads((tmp_path / f"{case}_out{rank}.pkl").read_bytes())
            for rank in range(world)]


TINY = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=(8, 8), attention_levels=(False, False), norm_num_groups=8,
            num_head_channels=8)
LR, EPS = 1e-3, 1e-3


def unet_pair(cfg: dict, shape: tuple, seed: int, **call_kw):
    """(JAX model, numpy params, the port's state dict as numpy)."""
    jmodel = JaxUNet(**cfg)
    args = [jnp.zeros(shape), jnp.zeros((shape[0],), jnp.int32)]
    if "context" in call_kw:
        args.append(call_kw["context"])
    struct = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"]
    params = random_params(struct, seed)
    port = DiffusionModelUNet(**cfg)
    state = {k: v.numpy() for k, v in unet_state_dict_from_jax(params, port.state_dict()).items()}
    return jmodel, params, state


def jax_draws(rng, images, T=1000):
    """The noise and timesteps the JAX step draws from `rng`."""
    k_noise, k_t = jax.random.split(rng)
    noise = jax.random.normal(k_noise, images.shape, dtype=images.dtype)
    timesteps = jax.random.randint(k_t, (images.shape[0],), 0, T)
    return np.asarray(noise), np.asarray(timesteps).astype(np.int64)


def jax_step(jmodel, params, images, rng, **kw):
    """The JAX single-device step on the full batch: (loss, new params)."""
    tx = optax.adam(LR, eps=EPS)
    apply = lambda p, x, t: jmodel.apply({"params": p}, x, t)  # noqa: E731
    step = jtrain.make_diffusion_train_step(apply, JaxDDPM(num_train_timesteps=1000), tx,
                                            donate=False, **kw)
    state, loss = step(jtrain.init_train_state(params, tx, ema="ema_decay" in kw),
                       jnp.asarray(images), rng)
    return float(loss), state


def l1_norm(tree) -> float:
    return float(sum(np.abs(np.asarray(leaf, np.float64)).sum()
                     for leaf in jax.tree_util.tree_leaves(tree)))


def port_l1_norm(params: dict) -> float:
    return float(sum(np.abs(v.astype(np.float64)).sum() for v in params.values()))


def codebook_inputs(seed: int) -> tuple[dict, dict, np.ndarray]:
    """(port EMAQuantizer kwargs, its buffers, a global batch) and the JAX
    codebook they come from."""
    cfg = dict(spatial_dims=2, num_embeddings=4, embedding_dim=2, decay=0.5)
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((4, 2, 2, 2)).astype(np.float32)
    x[2:] += 1.0  # the two ranks' rows differ
    codebook = dict(JaxEMA(**cfg, ddp_sync=False).init(
        jax.random.PRNGKey(seed), jnp.asarray(x).transpose(0, 2, 3, 1))["codebook"])
    codebook = {k: np.asarray(v) for k, v in codebook.items()}
    state = {"embedding.weight": codebook["embedding"],
             "ema_cluster_size": codebook["ema_cluster_size"], "ema_w": codebook["ema_w"]}
    return cfg, state, x


def jax_codebook(cfg: dict, state: dict, x: np.ndarray) -> dict:
    """The JAX global update of the codebook on the full batch."""
    variables = {"codebook": {"embedding": state["embedding.weight"],
                              "ema_cluster_size": state["ema_cluster_size"],
                              "ema_w": state["ema_w"]}}
    _, mut = JaxEMA(**cfg, ddp_sync=False).apply(
        variables, jnp.asarray(x).transpose(0, 2, 3, 1), train=True, mutable=["codebook"])
    cb = mut["codebook"]
    return {"embedding.weight": np.asarray(cb["embedding"]),
            "ema_cluster_size": np.asarray(cb["ema_cluster_size"]),
            "ema_w": np.asarray(cb["ema_w"])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One two-rank spawn of every check, with the JAX references."""
    tmp = tmp_path_factory.mktemp("processes")
    jmodel, params, state = unet_pair(TINY, (4, 1, 8, 8), seed=0)
    images = np.random.RandomState(7).rand(4, 1, 8, 8).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    noise, timesteps = jax_draws(rng, jnp.asarray(images))
    sample_noise = np.random.RandomState(5).randn(4, 1, 8, 8).astype(np.float32)
    cfg, cb_state, cb_x = codebook_inputs(11)

    part_dir, batch_dir = tmp / "part", tmp / "batch"
    part_dir.mkdir()
    batch_dir.mkdir()
    rs = np.random.RandomState(0)
    for i in range(8):
        np.save(part_dir / f"img{i}.npy", np.full((6, 6), float(i), np.float32))
        np.save(batch_dir / f"img{i}.npy", rs.rand(6, 6).astype(np.float32))

    inputs = dict(cfg=TINY, state=state, lr=LR, eps=EPS, images=images, noise=noise,
                  timesteps=timesteps, sample_noise=sample_noise,
                  codebook=dict(cfg=cfg, state=cb_state, x=cb_x),
                  part_dir=str(part_dir), batch_dir=str(batch_dir))
    outs = spawn("processes", 2, inputs, tmp)

    ref_loss, ref_state = jax_step(jmodel, params, images, rng)
    sched = JaxDDIM(num_train_timesteps=100)
    sched.set_timesteps(10)
    fn = lambda x, t, context=None: jmodel.apply({"params": params}, x, t)  # noqa: E731
    ref_sample = np.asarray(JaxInferer(sched).sample(jnp.asarray(sample_noise), fn))
    return dict(outs=outs, ref_loss=ref_loss, ref_norm=l1_norm(ref_state.params),
                ref_sample=ref_sample, ref_codebook=jax_codebook(cfg, cb_state, cb_x))


def test_cross_process_psum(world):
    assert [o["count"] for o in world["outs"]] == [2, 2]
    assert all(o["psum"] == 3.0 for o in world["outs"])


def test_cross_process_codebook_sync(world):
    for o in world["outs"]:
        # 16 latent vectors over both processes, counts from 0, decay 0.5
        assert abs(float(o["codebook"]["ema_cluster_size"].sum()) - 16 * 0.5) < 1e-5
        for name, want in world["ref_codebook"].items():
            np.testing.assert_allclose(o["codebook"][name], want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_cross_process_diffusion_train_step(world):
    for o in world["outs"]:
        assert abs(o["step"]["loss"] - world["ref_loss"]) < 1e-6
        norm = port_l1_norm(o["step"]["params"])
        assert abs(norm - world["ref_norm"]) / world["ref_norm"] < 1e-6


def test_cross_process_sharded_sampling(world):
    for rank, o in enumerate(world["outs"]):
        want = world["ref_sample"][rank * 2:(rank + 1) * 2]
        assert np.isfinite(o["sample"]).all()
        assert float(np.abs(o["sample"] - want).max()) < 1e-5


def test_multihost_data_partition_and_global_batch(world):
    by_rank = {o["rank"]: o for o in world["outs"]}
    assert by_rank[0]["vals"] == [0, 2, 4, 6]
    assert by_rank[1]["vals"] == [1, 3, 5, 7]
    assert by_rank[0]["local_shape"] == by_rank[1]["local_shape"] == (2, 1, 6, 6)
    assert abs(by_rank[0]["global_mean"] - by_rank[1]["global_mean"]) < 1e-6
    assert np.isfinite(by_rank[0]["global_mean"])
    assert abs(by_rank[0]["local_mean"] - by_rank[1]["local_mean"]) > 1e-9
