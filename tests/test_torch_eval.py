"""The two eval recipes at tiny sizes on the CPU, and the train-save-serve round
trip.

eval_quality and eval_brain_ldm write the JAX recipes' JSON keys; their
MS-SSIM weights, diversity and the brain recipe's FID trunk are held
against the JAX package (the trunk with the JAX trunk's seeded weights
carried over: features within 1e-5 of their largest value, as the
backbone tests; MS-SSIM within 1e-5). The brain recipe's full-width UNet,
built from the port's preset with 3 input channels, has the JAX clone's
parameter sizes (`jax.eval_shape`, nothing computed; torch's meta device).
A model trained by `train_2d_ddpm --checkpoint-dir` and served from that
directory gives the same images, to the bit, as sampling the trained model
in process from the same noise.
"""
from __future__ import annotations

import base64
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.config import load_preset as jax_load_preset
from generativemodels_tpu.metrics import MultiScaleSSIMMetric as JaxMSSSIM
from generativemodels_tpu.networks.backbones import ResNetFeatures as JaxResNetFeatures
from generativemodels_tpu.recipes import eval_brain_ldm as jax_eval_brain
from generativemodels_tpu.recipes import eval_quality as jax_eval_quality
from generativemodels_tpu_torch.data import write_nifti
from generativemodels_tpu_torch.inferers import DiffusionInferer
from generativemodels_tpu_torch.networks import backbone_state_dict_from_jax
from generativemodels_tpu_torch.networks.schedulers import DDIMScheduler
from generativemodels_tpu_torch.recipes import eval_brain_ldm, eval_quality, serve, train_2d_ddpm
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

QUALITY_KEYS = {"preset", "config", "data", "train_steps", "final_train_loss", "loss_curve",
                "train_seconds", "sample_count", "sample_seconds", "fid_features", "fid",
                "ms_ssim_diversity", "backend"}
BRAIN_KEYS = {"preset", "published_reference", "plumbing_only", "sample_count",
              "same_cond_pairs", "ddim_steps", "latent_shape", "out_shape", "sample_seconds",
              "msssim", "msssim_4g", "fid", "fid_features", "backend"}
TINY_2D = ["--batch", "4", "--size", "16", "--channels", "16", "32", "--norm-groups", "8"]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(8):
        np.save(d / f"x{i}.npy", (rng.random((40, 36)) * 255).astype(np.float32))
    return str(d)


@pytest.mark.parametrize("size", [16, 32, 64, 100, 176, 512])
def test_ms_ssim_weights_match_jax(size):
    assert eval_quality.ms_ssim_weights_for(size) == jax_eval_quality.ms_ssim_weights_for(size)


def test_diversity_ms_ssim_matches_jax():
    rng = np.random.default_rng(1)
    samples = rng.random((6, 1, 64, 64), dtype=np.float32)
    samples[3:] = np.clip(samples[:3] + 0.1 * rng.standard_normal((3, 1, 64, 64)), 0, 1)
    metric = JaxMSSSIM(spatial_dims=2, data_range=1.0,
                       weights=jax_eval_quality.ms_ssim_weights_for(64))
    want = float(jnp.mean(metric(jnp.asarray(samples[:3]), jnp.asarray(samples[3:]))))
    got = float(eval_quality.diversity_ms_ssim(torch.from_numpy(samples)))
    assert want > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_eval_quality_main(tmp_path, image_dir):
    out = tmp_path / "quality.json"
    with pytest.warns(UserWarning, match="RANDOM ResNet50"):
        result = eval_quality.main([
            "--train-steps", "2", "--channels", "8", "8", "--norm-groups", "8", "--batch", "4",
            "--size", "32", "--sample-count", "4", "--sample-batch", "4", "--ddim-steps", "2",
            "--data-dir", image_dir, "--out", str(out), "--device", "cpu",
        ])
    written = json.loads(out.read_text())
    assert set(written) == QUALITY_KEYS
    assert np.isfinite(written["fid"]) and -1.0 <= written["ms_ssim_diversity"] <= 1.0
    assert written["sample_count"] == 4 and written["data"] == image_dir
    assert tuple(result["samples"].shape) == (4, 1, 32, 32)
    assert tuple(result["real"].shape) == (4, 1, 32, 32)
    assert float(result["real"].min()) >= 0 and float(result["real"].max()) <= 1


def test_brain_fid_trunk_matches_jax(tmp_path):
    module = JaxResNetFeatures(spatial_dims=3, block="basic", layers=(1, 1, 1, 1))
    variables = module.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 16, 1)))
    port_trunk = eval_brain_ldm.feature_trunk(3, "basic", (1, 1, 1, 1), None,
                                              "medicalnet_resnet10", 0, "cpu")
    weights = tmp_path / "medicalnet.pth"
    torch.save(backbone_state_dict_from_jax(variables["params"], port_trunk.state_dict(),
                                            "medicalnet_resnet10", variables["batch_stats"]),
               weights)
    x = np.random.default_rng(2).standard_normal((2, 1, 16, 16, 16)).astype(np.float32) + 3
    want = np.asarray(jax_eval_brain.make_3d_feature_extractor(None)(jnp.asarray(x)))
    got = eval_brain_ldm.make_3d_feature_extractor(str(weights), device="cpu")(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 512)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_brain_unet_is_the_jax_clone():
    with torch.device("meta"):
        unet, aekl = eval_brain_ldm.build_models(tiny=False, dtype=torch.bfloat16)
    assert unet.conv_in.conv.weight.shape[1] == 3 and unet.dtype == torch.bfloat16
    jax_unet = jax_load_preset("brain_3d_ldm").resolve("network").clone(in_channels=3)
    shapes = jax.eval_shape(jax_unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 8, 8)),
                            jnp.zeros((1,), jnp.int32), context=jnp.zeros((1, 1, 4)))
    want = sorted(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert sorted(p.numel() for p in unet.parameters()) == want


def test_eval_brain_ldm_tiny(tmp_path):
    volumes = tmp_path / "volumes"
    volumes.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        write_nifti(str(volumes / f"v{i}.nii"), rng.random((9, 10, 11)).astype(np.float32))
    out = tmp_path / "brain.json"
    result = eval_brain_ldm.main([
        "--tiny", "--sample-count", "4", "--same-cond-pairs", "1", "--ddim-steps", "2",
        "--dtype", "f32", "--data-dir", str(volumes), "--out", str(out), "--device", "cpu",
    ])
    written = json.loads(out.read_text())
    assert set(written) == BRAIN_KEYS
    assert written["plumbing_only"] is True and written["published_reference"]["msssim"] == 0.6555
    assert written["out_shape"] == [4, 1, 8, 8, 8] and written["preset"] == "brain_3d_ldm (tiny)"
    assert -1.0 <= written["msssim"] <= 1.0 and -1.0 <= written["msssim_4g"] <= 1.0
    assert np.isfinite(written["fid"]) and written["backend"] == "cpu"
    assert bool(torch.isfinite(result["diverse"]).all())


def _post(port: int, seed: int, n: int) -> np.ndarray:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sample", data=json.dumps({"n": n, "seed": seed}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=120) as resp:
        body = json.loads(resp.read())
    return np.load(io.BytesIO(base64.b64decode(body["data_b64"])))


def test_train_save_serve_round_trip(tmp_path, image_dir):
    ckpt = str(tmp_path / "ckpt")
    out = train_2d_ddpm.main([*TINY_2D, "--steps", "3", "--data-dir", image_dir, "--augment",
                              "--cache", "--checkpoint-dir", ckpt, "--device", "cpu"])
    sampler, shape = serve.build_sampler(size=16, channels=(16, 32), norm_groups=8, batch=2,
                                         ddim_steps=3, device="cpu", checkpoint_dir=ckpt)
    httpd = serve.start_server(serve._SamplerState(sampler, shape), port=0)
    try:
        served = [_post(httpd.server_port, seed, 2) for seed in (0, 5)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    model = out["state"].model.eval()
    ddim = DDIMScheduler(num_train_timesteps=1000)
    ddim.set_timesteps(3)
    for seed, images in zip((0, 5), served):
        g = torch.Generator().manual_seed(seed)
        noise = torch.randn(shape, generator=g)
        with torch.inference_mode():
            want = DiffusionInferer(ddim).sample(noise, model, generator=g).numpy()
        np.testing.assert_array_equal(images, want)
    untrained, _ = serve.build_sampler(size=16, channels=(16, 32), norm_groups=8, batch=2,
                                       ddim_steps=3, device="cpu")
    assert not np.array_equal(untrained(0).numpy(), served[0])
