"""The serving slice end to end: inferer, sampler, HTTP server and entry point.

The DDIM chain of the port is held against the JAX DiffusionInferer with the
same weights (carried by `unet_state_dict_from_jax`) and the same numpy
noise, at atol 1e-4 (f32: the per-forward agreement of test_torch_unet.py,
over five steps whose x0-clipping keeps values in [-1, 1]). The
DPM-Solver++ (2M) 10-step chain, which does not clip, is held at atol 1e-3
plus rtol 1e-3: its data prediction divides the forward's 1e-4 by
sqrt(alpha_bar) = 0.0064 at t = 999, and the random-weight chain ends at
values up to ~500 (the two chains differ by 2.1e-4 there).
"""
from __future__ import annotations

import base64
import io
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.inferers import DiffusionInferer as JaxInferer
from generativemodels_tpu.networks.schedulers import DDIMScheduler as JaxDDIM
from generativemodels_tpu.networks.schedulers import DPMSolverMultistepScheduler as JaxDPM
from generativemodels_tpu_torch.inferers import DiffusionInferer
from generativemodels_tpu_torch.networks.schedulers import (
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverMultistepScheduler,
)
from generativemodels_tpu_torch.recipes import serve

from .test_torch_unet import BATCH, SPATIAL, build_pair
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_SERVE = dict(size=16, channels=(32, 64, 64), norm_groups=8, batch=2, ddim_steps=2)
# loopback only: never route the requests through a proxy from the environment
_http = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def test_ddim_sampling_chain_matches_jax():
    jmodel, params, port = build_pair(seed=7, use_flash_attention=True)
    noise = np.random.RandomState(8).standard_normal((BATCH, 1, *SPATIAL)).astype(np.float32)

    jsched = JaxDDIM(num_train_timesteps=1000)
    jsched.set_timesteps(5)
    j_img = JaxInferer(jsched).sample(
        jnp.asarray(noise),
        lambda x, t, context=None: jmodel.apply({"params": params}, x, t),
    )
    sched = DDIMScheduler(num_train_timesteps=1000)
    sched.set_timesteps(5)
    with torch.no_grad():
        img = DiffusionInferer(sched).sample(torch.from_numpy(noise), port)
    assert float(np.abs(np.asarray(j_img)).max()) > 0.1
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-4, rtol=0)


def test_dpmsolver_sampling_chain_matches_jax():
    """The inferer's stateful branch: DPM-Solver++ (2M), 10 steps."""
    jmodel, params, port = build_pair(seed=10, use_flash_attention=True)
    noise = np.random.RandomState(11).standard_normal((BATCH, 1, *SPATIAL)).astype(np.float32)
    jsched = JaxDPM(num_train_timesteps=1000)
    jsched.set_timesteps(10)
    j_img = JaxInferer(jsched).sample(
        jnp.asarray(noise),
        lambda x, t, context=None: jmodel.apply({"params": params}, x, t),
    )
    sched = DPMSolverMultistepScheduler(num_train_timesteps=1000)
    sched.set_timesteps(10)
    with torch.no_grad():
        img = DiffusionInferer(sched).sample(torch.from_numpy(noise), port)
    assert float(np.abs(np.asarray(j_img)).max()) > 0.1
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-3, rtol=1e-3)


def test_ddpm_sampling_draws_from_the_generator():
    """DDPM sampling is reproducible from its generator and differs across seeds."""
    _, _, port = build_pair(seed=9)
    sched = DDPMScheduler(num_train_timesteps=20)
    sched.set_timesteps(4)
    noise = torch.zeros((BATCH, 1, *SPATIAL))

    def run(seed):
        with torch.no_grad():
            return DiffusionInferer(sched).sample(
                noise, port, generator=torch.Generator().manual_seed(seed)
            )

    torch.testing.assert_close(run(0), run(0), rtol=0, atol=0)
    assert not torch.equal(run(0), run(1))


def _get(port, path):
    with _http.open(f"http://127.0.0.1:{port}{path}", timeout=120) as resp:
        return json.loads(resp.read())


def _post_sample(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sample", data=json.dumps(body).encode(), method="POST"
    )
    with _http.open(req, timeout=120) as resp:
        out = json.loads(resp.read())
    return np.load(io.BytesIO(base64.b64decode(out["data_b64"])))


def test_sampler_behind_http_server():
    sampler, shape = serve.build_sampler(device="cpu", **TINY_SERVE)
    assert shape == (2, 1, 16, 16)
    httpd = serve.start_server(serve._SamplerState(sampler, shape), port=0)
    try:
        health = _get(httpd.server_port, "/healthz")
        assert health["status"] == "ok" and health["shape"] == list(shape)
        a = _post_sample(httpd.server_port, {"n": 3, "seed": 5})
        b = _post_sample(httpd.server_port, {"n": 3, "seed": 5})
        assert a.shape == (3, 1, 16, 16) and a.dtype == np.float32
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
        assert _get(httpd.server_port, "/healthz")["served"] == 6
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("solver", serve.SOLVERS)
def test_build_sampler_solvers(solver):
    """Each solver samples finite images, reproducibly from the request seed."""
    sampler, shape = serve.build_sampler(device="cpu", solver=solver, **TINY_SERVE)
    scheduler = sampler.inferer.scheduler
    want = DDIMScheduler if solver == "ddim" else DPMSolverMultistepScheduler
    assert type(scheduler) is want and scheduler.num_inference_steps == 2
    if solver != "ddim":
        assert scheduler.algorithm_type == ("sde-dpmsolver++" if solver == "sde-dpmsolver"
                                            else "dpmsolver++")
    a, b = sampler(3), sampler(3)
    assert a.shape == shape and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="solver"):
        serve.build_sampler(device="cpu", solver="pndm", **TINY_SERVE)


def test_main_with_cuda_device_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--device", "cuda", "--oneshot"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_sampler(device="cuda", **TINY_SERVE)
