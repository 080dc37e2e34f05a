"""The port's inferers against the JAX ones: LatentDiffusionInferer
(`__call__`, `sample` with and without intermediates and latent-shape
adapters, `get_likelihood` with resampled KL maps), DiffusionInferer's
`get_likelihood` and PNDM sampling, and the latent helpers.

A small 2D AutoencoderKL ((8, 16) channels, 4 groups, 16x16 images, an
8x8 latent of 3 channels) and a small latent UNet ((8, 16), 4 groups), all
weights drawn from a numpy seed and carried across by the port's
converters; noise, timesteps and the corruption noise are injected. The
stage-1 model in `__call__` and `get_likelihood` is a duck-typed wrapper
whose `encode_stage_2_inputs` returns z_mu (the two frameworks draw the
latent sample from different generators). Tolerance: max|diff| <= 1e-5 of
max|JAX output| (f32 sums in another order).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.inferers import DiffusionInferer as JaxInferer
from generativemodels_tpu.inferers import LatentDiffusionInferer as JaxLatentInferer
from generativemodels_tpu.inferers import latent as jax_latent
from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import AutoencoderKL as JaxAEKL
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu_torch.inferers import DiffusionInferer, LatentDiffusionInferer
from generativemodels_tpu_torch.inferers import latent as port_latent
from generativemodels_tpu_torch.networks import (
    autoencoderkl_state_dict_from_jax,
    schedulers as tsched,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import AutoencoderKL, DiffusionModelUNet
from generativemodels_tpu_torch.probes import bench_3d_ldm
from tests.test_torch_unet import random_params
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
BATCH = 2
AEKL = dict(
    spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1, num_channels=(8, 16),
    attention_levels=(False, False), latent_channels=3, norm_num_groups=4,
    with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
)
UNET = dict(
    spatial_dims=2, in_channels=3, out_channels=3, num_res_blocks=1, num_channels=(8, 16),
    attention_levels=(False, False), norm_num_groups=4,
)
IMAGE = (BATCH, 1, 16, 16)
LATENT = (BATCH, 3, 8, 8)


class _Stage1:
    """A deterministic stage 1: encode_stage_2_inputs gives z_mu."""

    def __init__(self, encode, decode):
        self._encode, self._decode = encode, decode

    def encode_stage_2_inputs(self, x, **_):
        return self._encode(x)[0]

    def decode_stage_2_outputs(self, z):
        return self._decode(z)


@pytest.fixture(scope="module")
def aekl():
    """(JAX stage 1, port stage 1), the same weights."""
    jmodel = JaxAEKL(**AEKL)
    struct = zoo_convert.params_structure(jmodel, jnp.zeros(IMAGE), method=JaxAEKL.reconstruct)
    params = random_params(struct, 0)
    port = AutoencoderKL(**AEKL)
    port.load_state_dict(autoencoderkl_state_dict_from_jax(
        params, port.state_dict(), AEKL["num_channels"], 1, AEKL["attention_levels"], False,
        False), strict=True)
    bound = jmodel.bind({"params": params})
    return _Stage1(bound.encode, bound.decode), _Stage1(port.eval().encode, port.decode)


def unet_pair(seed: int, **overrides):
    """(JAX model callable, port model callable), the same weights."""
    cfg = dict(UNET, **overrides)
    jmodel = JaxUNet(**cfg)
    latent = (BATCH, cfg["in_channels"], 8, 8)
    struct = zoo_convert.params_structure(
        jmodel, jnp.zeros(latent), jnp.zeros((BATCH,), jnp.int32))
    params = random_params(struct, seed)
    port = DiffusionModelUNet(**cfg)
    port.load_state_dict(unet_state_dict_from_jax(params, port.state_dict()), strict=True)
    port.eval()

    def jfn(x, t, context=None):
        return jmodel.apply({"params": params}, x, t)

    def tfn(x, t, context=None):
        return port(x, t)

    return jfn, tfn


@pytest.fixture(scope="module")
def unet():
    return unet_pair(1)


def rand(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def assert_close(got: torch.Tensor, want, rtol: float = RTOL) -> None:
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0  # the check is not empty
    assert float(np.abs(got - want).max()) <= rtol * scale


def assert_maps_close(got: list[torch.Tensor], want: list) -> None:
    """A likelihood's KL maps, held as one output to 1e-5 of its largest
    value: a map of 1e-5 (late t) is the difference of posterior and
    predicted means of order 1, squared, so the tables' f32 ulps move it
    by ~1e-4 of itself; its error follows the series' largest terms."""
    assert len(got) == len(want)
    assert_close(torch.stack(got), np.stack([np.asarray(w) for w in want]))


def schedulers(name: str, steps: int, **kw):
    j = getattr(jsched, name)(**kw)
    t = getattr(tsched, name)(**kw)
    j.set_timesteps(steps)
    t.set_timesteps(steps)
    return j, t


@pytest.mark.parametrize(
    "shape, target",
    [((2, 3, 5, 8), (8, 5)), ((2, 3, 6, 6), (6, 9)), ((1, 2, 4, 7, 5), (7, 4, 2))],
    ids=["pad_and_crop_odd", "pad_odd", "3d"],
)
def test_center_pad_or_crop_matches_jax(shape, target):
    x = rand(shape, 0)
    got = port_latent._center_pad_or_crop(torch.from_numpy(x), target)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_latent._center_pad_or_crop(jnp.asarray(x), target)))


@pytest.mark.parametrize(
    "shape, target, method",
    [((2, 3, 5, 5), (7, 12), "nearest"), ((2, 3, 5, 5), (7, 12), "bilinear"),
     ((1, 2, 3, 4, 5), (6, 9, 10), "trilinear"), ((1, 2, 3, 4, 5), (6, 9, 10), "nearest")],
)
def test_resize_spatial_matches_jax(shape, target, method):
    """Upsampling by uneven factors: JAX's nearest takes half-pixel centres
    (torch's nearest-exact), its linear is align_corners=False."""
    x = rand(shape, 1)
    got = port_latent._resize_spatial(torch.from_numpy(x), target, method)
    want = jax_latent._resize_spatial(jnp.asarray(x), target, method)
    assert_close(got, want)


def test_call_matches_jax(aekl, unet):
    (j1, t1), (jfn, tfn) = aekl, unet
    jsch, tsch = schedulers("DDPMScheduler", 10)
    x, noise = rand(IMAGE, 2), rand(LATENT, 3)
    steps = np.array([3, 970])
    want = JaxLatentInferer(jsch, scale_factor=0.5)(
        jnp.asarray(x), j1, jfn, jnp.asarray(noise), jnp.asarray(steps, jnp.int32))
    with torch.no_grad():
        got = LatentDiffusionInferer(tsch, scale_factor=0.5)(
            torch.from_numpy(x), t1, tfn, torch.from_numpy(noise), torch.from_numpy(steps))
    assert_close(got, want)
    # a SPADE segmentation reaches the diffusion model as `seg=`
    seg = rand(LATENT, 4)
    want = JaxLatentInferer(jsch, scale_factor=0.5)(
        jnp.asarray(x), j1, lambda z, t, context=None, seg=None: jfn(z, t) + seg,
        jnp.asarray(noise), jnp.asarray(steps, jnp.int32), seg=jnp.asarray(seg))
    with torch.no_grad():
        got = LatentDiffusionInferer(tsch, scale_factor=0.5)(
            torch.from_numpy(x), t1, lambda z, t, context=None, seg=None: tfn(z, t) + seg,
            torch.from_numpy(noise), torch.from_numpy(steps), seg=torch.from_numpy(seg))
    assert_close(got, want)


def _smooth_model(tanh, cat=None):
    """A deterministic stand-in for the diffusion model, the same function
    in both frameworks (with `cat`, a second half of channels: a variance
    value in (-1, 1) for learned_range), so that what follows the model can
    be held to f32 rounding: a random UNet's chain spreads the UNet's own
    ~1e-6 relative difference (the chain ends ~2e-5 apart), and the
    likelihood terms cancel to far below their parts (a KL map of 1e-5
    from terms of order 1; the decoder NLL of two CDF values near 1) and
    magnify it likewise. `test_ddim_chain_steps_match_jax` holds the UNet
    step by step, `test_call_matches_jax` and the PNDM samples whole."""

    def fn(x, t, context=None):
        eps = 0.5 * tanh(x) + 1e-4 * t.reshape(-1, 1, 1, 1)
        return eps if cat is None else cat([eps, tanh(2.0 * x)])

    return fn


SMOOTH = {
    "epsilon": (_smooth_model(jnp.tanh), _smooth_model(torch.tanh)),
    "learned": (_smooth_model(jnp.tanh, lambda xs: jnp.concatenate(xs, axis=1)),
                _smooth_model(torch.tanh, lambda xs: torch.cat(xs, dim=1))),
}


@pytest.mark.parametrize("adapt", [False, True], ids=["same_shape", "padded_latent"])
def test_sample_matches_jax(aekl, adapt):
    """DDIM-10 with eta 0, decoded, with the intermediates every 300
    timesteps; `padded_latent` runs the model on a 10x10 latent that is
    cropped back to the autoencoder's 8x8 before each decode."""
    j1, t1 = aekl
    jfn, tfn = SMOOTH["epsilon"]
    jsch, tsch = schedulers("DDIMScheduler", 10)
    shapes = dict(ldm_latent_shape=(10, 10), autoencoder_latent_shape=(8, 8)) if adapt else {}
    noise = rand((BATCH, 3, 10, 10) if adapt else LATENT, 4)
    kw = dict(save_intermediates=True, intermediate_steps=300)
    j_img, j_mid = JaxLatentInferer(jsch, scale_factor=0.5, **shapes).sample(
        jnp.asarray(noise), j1, jfn, **kw)
    with torch.no_grad():
        t_img, t_mid = LatentDiffusionInferer(tsch, scale_factor=0.5, **shapes).sample(
            torch.from_numpy(noise), t1, tfn, **kw)
        plain = LatentDiffusionInferer(tsch, scale_factor=0.5, **shapes).sample(
            torch.from_numpy(noise), t1, tfn)
    assert t_img.shape == IMAGE
    assert_close(t_img, j_img)
    torch.testing.assert_close(plain, t_img, rtol=0, atol=0)
    assert len(t_mid) == len(j_mid) == 4  # t = 900, 600, 300, 0
    for got, want in zip(t_mid, j_mid):
        assert_close(got, want)


def test_ddim_chain_steps_match_jax(unet):
    """The latent UNet's DDIM-10 chain, each step from the JAX chain's own
    sample (as chip_smoke.py's `chain_step_diff`)."""
    jfn, tfn = unet
    jsch, tsch = schedulers("DDIMScheduler", 10)
    sample = rand(LATENT, 4)
    for i, step in enumerate(jsch.timesteps):
        tt = np.full((BATCH,), step)
        want, _ = jsch.step(jfn(jnp.asarray(sample), jnp.asarray(tt, jnp.int32)), int(step),
                            jnp.asarray(sample))
        with torch.no_grad():
            x = torch.from_numpy(sample.copy())
            got, _ = tsch.step(tfn(x, torch.from_numpy(tt)), tsch.timesteps[i], x)
        assert_close(got, want)
        sample = np.asarray(want)


def likelihoods(variance_type: str, save: bool):
    """DDPM-10 likelihoods (t = 900 .. 0: the Gaussian KL terms and the
    decoder NLL), JAX's and the port's; under learned_range the model gives
    a variance channel per channel."""
    jfn, tfn = SMOOTH["learned" if variance_type == "learned_range" else "epsilon"]
    jsch, tsch = schedulers("DDPMScheduler", 10, variance_type=variance_type)
    x, noise = np.tanh(rand(LATENT, 5)), rand(LATENT, 6)
    want = JaxInferer(jsch).get_likelihood(
        jnp.asarray(x), jfn, save_intermediates=save, noise=jnp.asarray(noise))
    with torch.no_grad():
        got = DiffusionInferer(tsch).get_likelihood(
            torch.from_numpy(x), tfn, save_intermediates=save, noise=torch.from_numpy(noise))
    return want, got


@pytest.mark.parametrize("save", [False, True], ids=["totals", "intermediates"])
def test_diffusion_likelihood_matches_jax(save):
    want, got = likelihoods("fixed_small", save)
    if save:
        (want, j_maps), (got, t_maps) = want, got
        assert len(t_maps) == 10
        assert_maps_close(t_maps, j_maps)
    assert got.shape == (BATCH,)
    assert_close(got, want)


def test_learned_range_likelihood_matches_jax():
    """The learned-variance branch. At t = 0 its decoder NLL is -log(cdf+ -
    cdf-), two f32 CDF values near 1 (a small learned variance gives
    arguments far into the tails): an element may round to a difference of
    one ulp of 1 on one side and to 0 (clipped to 1e-12, NLL 27.6) on the
    other. So that map is held as the probability cdf+ - cdf- = exp(-NLL):
    each CDF is 0.5 (1 + tanh(a)) of an argument a that carries a few ulps
    of its own (the frameworks' exp and tanh differ by up to two), so each
    lies within four f32 ulps of 1 (2**-23) of the other framework's, the
    difference within eight. The other maps and their share of the totals
    are held as above."""
    (j_total, j_maps), (t_total, t_maps) = likelihoods("learned_range", True)
    assert_maps_close(t_maps[:-1], j_maps[:-1])
    got, want = t_maps[-1].numpy(), np.asarray(j_maps[-1])
    assert np.abs(np.exp(-got) - np.exp(-want)).max() <= 8 * 2.0**-23
    t_rest = sum(m.mean(dim=(1, 2, 3)) for m in t_maps[:-1])
    assert_close(t_rest, sum(np.asarray(m).mean(axis=(1, 2, 3)) for m in j_maps[:-1]))
    # the totals are the maps' means summed
    torch.testing.assert_close(t_total, t_rest + t_maps[-1].mean(dim=(1, 2, 3)))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_latent_likelihood_matches_jax(aekl, mode):
    (j1, t1), (jfn, tfn) = aekl, SMOOTH["epsilon"]
    jsch, tsch = schedulers("DDPMScheduler", 10)
    x, noise = rand(IMAGE, 7), rand(LATENT, 8)
    kw = dict(save_intermediates=True, resample_latent_likelihoods=True,
              resample_interpolation_mode=mode)
    j_total, j_maps = JaxLatentInferer(jsch, scale_factor=0.5).get_likelihood(
        jnp.asarray(x), j1, jfn, noise=jnp.asarray(noise), **kw)
    with torch.no_grad():
        t_total, t_maps = LatentDiffusionInferer(tsch, scale_factor=0.5).get_likelihood(
            torch.from_numpy(x), t1, tfn, noise=torch.from_numpy(noise), **kw)
    assert_close(t_total, j_total)
    assert len(t_maps) == 10 and t_maps[0].shape == (BATCH, 3, 16, 16)
    assert_maps_close(t_maps, j_maps)
    with pytest.raises(ValueError, match="resample"):
        LatentDiffusionInferer(tsch).get_likelihood(
            torch.from_numpy(x), t1, tfn, resample_latent_likelihoods=True,
            resample_interpolation_mode="cubic")


@pytest.mark.parametrize("skip_prk", [False, True], ids=["prk", "plms_only"])
def test_pndm_sample_matches_jax(unet, skip_prk):
    """PNDM-10 through DiffusionInferer.sample (19 steps with the RK warm-up)."""
    jfn, tfn = unet
    jsch, tsch = schedulers("PNDMScheduler", 10, skip_prk_steps=skip_prk)
    noise = rand(LATENT, 9)
    want = JaxInferer(jsch).sample(jnp.asarray(noise), jfn)
    with torch.no_grad():
        got = DiffusionInferer(tsch).sample(torch.from_numpy(noise), tfn)
    assert_close(got, want)


def test_likelihood_needs_ddpm(unet):
    _, tfn = unet
    _, tsch = schedulers("DDIMScheduler", 10)
    with pytest.raises(NotImplementedError, match="DDPMScheduler"):
        DiffusionInferer(tsch).get_likelihood(torch.zeros(LATENT), tfn)
    with pytest.raises(ValueError, match="ldm_latent_shape"):
        LatentDiffusionInferer(tsch, ldm_latent_shape=(8, 8))


def test_bench_3d_ldm_rehearses_on_cpu(capsys):
    """The latent route's entry point at bench.py's widths on a 16^3
    volume (a 4^3 latent): one warm-up and one timed DPM-10 sample."""
    result = bench_3d_ldm.main(["--device", "cpu", "--size", "16", "--runs", "1",
                                "--solver", "dpm"])
    assert result["out_shape"] == [1, 1, 16, 16, 16] and result["device"] == "cpu"
    assert result["metric"] == "3d_16_ldm_dpmsolver10_samples_per_min"
    assert "card" not in result
    assert capsys.readouterr().out.strip() == json.dumps(result)
