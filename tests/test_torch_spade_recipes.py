"""The SPADE recipes at a tiny size, and a segmentation `seg` through the
three inferers (DiffusionInferer, LatentDiffusionInferer, and both ControlNet
inferers) against the JAX package.

The SPADE UNet, SPADE autoencoder and ControlNet carry the same weights on
both sides (numpy seeds, the port's converters); noise, timesteps and the
likelihood's corruption noise are injected. The stage-1 model is a
deterministic wrapper whose `encode_stage_2_inputs` returns z_mu (the two
frameworks draw the latent sample from different generators) and whose
decode takes `seg`. Tolerance: 1e-4 of the largest JAX output (a SPADE
norm scales its input's f32 rounding by 1/std; chains of three DDIM steps).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.inferers import DiffusionInferer as JaxInferer
from generativemodels_tpu.inferers import LatentDiffusionInferer as JaxLatentInferer
from generativemodels_tpu.inferers.controlnet import (
    ControlNetDiffusionInferer as JaxCNInferer,
)
from generativemodels_tpu.inferers.controlnet import (
    ControlNetLatentDiffusionInferer as JaxCNLatentInferer,
)
from generativemodels_tpu.networks import schedulers as jsched
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import ControlNet as JaxControlNet
from generativemodels_tpu.networks.nets import SPADEAutoencoderKL as JaxSPADEAEKL
from generativemodels_tpu.networks.nets import SPADEDiffusionModelUNet as JaxSPADEUNet
from generativemodels_tpu.recipes.train_spade_ldm import one_hot_labels as jax_one_hot
from generativemodels_tpu_torch.inferers import (
    ControlNetDiffusionInferer,
    ControlNetLatentDiffusionInferer,
    DiffusionInferer,
    LatentDiffusionInferer,
)
from generativemodels_tpu_torch.networks import (
    controlnet_state_dict_from_jax,
    schedulers as tsched,
    spade_autoencoderkl_state_dict_from_jax,
    spade_diffusion_model_unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import (
    ControlNet,
    SPADEAutoencoderKL,
    SPADEDiffusionModelUNet,
)
from generativemodels_tpu_torch.recipes import train_spade_ldm as tldm
from generativemodels_tpu_torch.recipes import train_spade_vae as tvae
from tests.test_torch_unet import random_params
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-4
B, LABEL_NC = 2, 3
IMAGE, LATENT, SEG = (B, 1, 16, 16), (B, 3, 8, 8), (B, LABEL_NC, 16, 16)
UNET = dict(spatial_dims=2, in_channels=3, out_channels=3, num_res_blocks=1,
            num_channels=(8, 16), attention_levels=(False, True), num_head_channels=8,
            norm_num_groups=4)
AEKL = dict(spatial_dims=2, label_nc=LABEL_NC, in_channels=1, out_channels=1,
            num_res_blocks=1, num_channels=(8, 16), attention_levels=(False, False),
            latent_channels=3, norm_num_groups=4, with_encoder_nonlocal_attn=False,
            with_decoder_nonlocal_attn=False, spade_intermediate_channels=8)


def rand(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def segmap(seed: int) -> np.ndarray:
    labels = np.random.RandomState(seed).randint(0, LABEL_NC, (B, 1) + SEG[2:])
    return np.array(jax_one_hot(jnp.asarray(labels), LABEL_NC))


def assert_close(got, want, rtol: float = RTOL) -> None:
    got, want = np.asarray(got.detach(), np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    assert float(np.abs(got - want).max()) <= rtol * scale


class _Stage1:
    """A deterministic SPADE stage 1: encode_stage_2_inputs gives z_mu;
    decode_stage_2_outputs(z, seg) is the SPADE decode."""

    label_nc = LABEL_NC

    def __init__(self, encode, decode):
        self._encode, self._decode = encode, decode

    def encode_stage_2_inputs(self, x, **_):
        return self._encode(x)[0]

    def decode_stage_2_outputs(self, z, seg):
        return self._decode(z, seg)


@pytest.fixture(scope="module")
def models():
    """JAX and port callables, the same weights: the SPADE UNet (called with
    seg), the SPADE stage 1 and a ControlNet of the UNet's down path."""
    x, t = jnp.zeros(LATENT), jnp.zeros((B,), jnp.int32)
    junet = JaxSPADEUNet(label_nc=LABEL_NC, spade_intermediate_channels=8, **UNET)
    u_params = random_params(zoo_convert.params_structure(junet, x, t, jnp.zeros(SEG)), 0)
    unet = SPADEDiffusionModelUNet(label_nc=LABEL_NC, spade_intermediate_channels=8, **UNET)
    unet.load_state_dict(spade_diffusion_model_unet_state_dict_from_jax(
        u_params, unet.state_dict()), strict=True)
    # one embedding level: no stride, the control image at the latent's size
    cn_cfg = dict(UNET, conditioning_embedding_in_channels=1,
                  conditioning_embedding_num_channels=(8,))
    cn_cfg.pop("out_channels")
    jcn = JaxControlNet(**cn_cfg)
    cn_params = random_params(zoo_convert.params_structure(
        jcn, x, t, controlnet_cond=jnp.zeros((B, 1) + LATENT[2:])), 1)
    cn = ControlNet(**cn_cfg)
    cn.load_state_dict(controlnet_state_dict_from_jax(cn_params, cn.state_dict()), strict=True)
    jaekl = JaxSPADEAEKL(**AEKL)
    a_params = random_params(zoo_convert.params_structure(
        jaekl, jnp.zeros(IMAGE), jnp.zeros(SEG), method=JaxSPADEAEKL.reconstruct), 2)
    aekl = SPADEAutoencoderKL(**AEKL)
    aekl.load_state_dict(spade_autoencoderkl_state_dict_from_jax(
        a_params, aekl.state_dict(), AEKL["num_channels"], 1, AEKL["attention_levels"], False,
        False), strict=True)
    unet.eval(), cn.eval(), aekl.eval()

    def jfn(x, t, context=None, seg=None, **kw):
        return junet.apply({"params": u_params}, x, t, seg, context=context, **kw)

    def jcontrol(x, t, controlnet_cond=None, context=None):
        return jcn.apply({"params": cn_params}, x, t, controlnet_cond=controlnet_cond,
                         context=context)

    bound = jaekl.bind({"params": a_params})
    return dict(
        jax=(jfn, jcontrol, _Stage1(bound.encode, bound.decode)),
        port=(unet, cn, _Stage1(aekl.encode, aekl.decode)),
    )


def _ddim(steps: int = 3):
    j, t = jsched.DDIMScheduler(num_train_timesteps=1000), tsched.DDIMScheduler(
        num_train_timesteps=1000)
    j.set_timesteps(steps)
    t.set_timesteps(steps)
    return j, t


def test_seg_through_diffusion_inferer_matches_jax(models):
    jfn, _, _ = models["jax"]
    unet, _, _ = models["port"]
    x, noise, seg = rand(LATENT, 3), rand(LATENT, 4), segmap(5)
    t = np.array([20, 800])
    jsch, tsch = _ddim()
    with torch.no_grad():
        want = JaxInferer(jsch)(jnp.asarray(x), jfn, jnp.asarray(noise), jnp.asarray(t),
                                seg=jnp.asarray(seg))
        got = DiffusionInferer(tsch)(torch.from_numpy(x), unet, torch.from_numpy(noise),
                                     torch.from_numpy(t), seg=torch.from_numpy(seg))
        assert_close(got, want)
        want = JaxInferer(jsch).sample(jnp.asarray(noise), jfn, seg=jnp.asarray(seg))
        got = DiffusionInferer(tsch).sample(torch.from_numpy(noise), unet,
                                            seg=torch.from_numpy(seg))
        assert_close(got, want)
        jddpm, tddpm = jsched.DDPMScheduler(num_train_timesteps=1000), tsched.DDPMScheduler(
            num_train_timesteps=1000)
        jddpm.set_timesteps(4)
        tddpm.set_timesteps(4)
        want = JaxInferer(jddpm).get_likelihood(jnp.asarray(x), jfn, seg=jnp.asarray(seg),
                                                noise=jnp.asarray(noise))
        got = DiffusionInferer(tddpm).get_likelihood(torch.from_numpy(x), unet,
                                                     seg=torch.from_numpy(seg),
                                                     noise=torch.from_numpy(noise))
        assert_close(got, want)


def test_seg_through_latent_inferer_matches_jax(models):
    """The training forward and a DDIM-3 chain with the SPADE decode."""
    jfn, _, jstage1 = models["jax"]
    unet, _, stage1 = models["port"]
    images, noise, seg = rand(IMAGE, 6), rand(LATENT, 7), segmap(8)
    t = np.array([5, 600])
    jsch, tsch = _ddim()
    with torch.no_grad():
        want = JaxLatentInferer(jsch, scale_factor=0.7)(
            jnp.asarray(images), jstage1, jfn, jnp.asarray(noise), jnp.asarray(t),
            seg=jnp.asarray(seg))
        got = LatentDiffusionInferer(tsch, scale_factor=0.7)(
            torch.from_numpy(images), stage1, unet, torch.from_numpy(noise),
            torch.from_numpy(t), seg=torch.from_numpy(seg))
        assert_close(got, want)
        want = JaxLatentInferer(jsch, scale_factor=0.7).sample(
            jnp.asarray(noise), jstage1, jfn, seg=jnp.asarray(seg))
        got = LatentDiffusionInferer(tsch, scale_factor=0.7).sample(
            torch.from_numpy(noise), stage1, unet, seg=torch.from_numpy(seg))
        assert got.shape == IMAGE
        assert_close(got, want)

    class Mismatched:
        label_nc = LABEL_NC + 1

        def __call__(self, *args, **kwargs):
            return unet(*args, **kwargs)

    with pytest.raises(ValueError, match="semantic labels"):
        LatentDiffusionInferer(tsch).sample(torch.from_numpy(noise), stage1, Mismatched(),
                                            seg=torch.from_numpy(seg))


def test_seg_through_controlnet_inferers_matches_jax(models):
    jfn, jcontrol, jstage1 = models["jax"]
    unet, cn, stage1 = models["port"]
    x, noise, seg = rand(LATENT, 9), rand(LATENT, 10), segmap(11)
    # the control image at the latent's size, and at the image's for the
    # latent inferer, which resizes it to the latent's
    cond, cond_image, images = rand((B, 1) + LATENT[2:], 12), rand(IMAGE, 15), rand(IMAGE, 13)
    t = np.array([40, 900])
    jsch, tsch = _ddim()
    with torch.no_grad():
        want = JaxCNInferer(jsch)(jnp.asarray(x), jfn, jcontrol, jnp.asarray(noise),
                                  jnp.asarray(t), cn_cond=jnp.asarray(cond), seg=jnp.asarray(seg))
        got = ControlNetDiffusionInferer(tsch)(
            torch.from_numpy(x), unet, cn, torch.from_numpy(noise), torch.from_numpy(t),
            cn_cond=torch.from_numpy(cond), seg=torch.from_numpy(seg))
        assert_close(got, want)
        want = JaxCNInferer(jsch).sample(jnp.asarray(noise), jfn, jcontrol, jnp.asarray(cond),
                                         seg=jnp.asarray(seg))
        got = ControlNetDiffusionInferer(tsch).sample(
            torch.from_numpy(noise), unet, cn, torch.from_numpy(cond), seg=torch.from_numpy(seg))
        assert_close(got, want)
        want = JaxCNLatentInferer(jsch, scale_factor=0.7).sample(
            jnp.asarray(noise), jstage1, jfn, jcontrol, jnp.asarray(cond_image),
            seg=jnp.asarray(seg))
        got = ControlNetLatentDiffusionInferer(tsch, scale_factor=0.7).sample(
            torch.from_numpy(noise), stage1, unet, cn, torch.from_numpy(cond_image),
            seg=torch.from_numpy(seg))
        assert got.shape == IMAGE
        assert_close(got, want)
        want = JaxCNLatentInferer(jsch, scale_factor=0.7)(
            jnp.asarray(images), jstage1, jfn, jcontrol, jnp.asarray(noise), jnp.asarray(t),
            cn_cond=jnp.asarray(cond_image), seg=jnp.asarray(seg))
        got = ControlNetLatentDiffusionInferer(tsch, scale_factor=0.7)(
            torch.from_numpy(images), stage1, unet, cn, torch.from_numpy(noise),
            torch.from_numpy(t), cn_cond=torch.from_numpy(cond_image), seg=torch.from_numpy(seg))
        assert_close(got, want)


def test_seg_batch_helpers_match_jax():
    labels = np.random.RandomState(14).randint(0, LABEL_NC, (B, 1, 6, 5))
    np.testing.assert_array_equal(
        tldm.one_hot_labels(torch.from_numpy(labels), LABEL_NC).numpy(),
        np.asarray(jax_one_hot(jnp.asarray(labels), LABEL_NC)))
    images, seg = tldm.synthetic_seg_batch(torch.Generator().manual_seed(0), B, 16, LABEL_NC)
    want = np.clip((np.asarray(images) * LABEL_NC).astype(np.int32), 0, LABEL_NC - 1)
    np.testing.assert_array_equal(seg.argmax(1, keepdim=True).numpy(), want)
    assert seg.shape == SEG and bool((seg.sum(1) == 1).all())


def test_spade_vae_recipe_main_at_a_tiny_size():
    out = tvae.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--size", "32",
                     "--sample"])
    assert len(out["outputs"]) == 2
    assert all(math.isfinite(v) for step in out["outputs"] for v in step.values())
    assert out["sample"].shape == (2, 1, 32, 32) and bool(torch.isfinite(out["sample"]).all())
    assert out["state"].step == 2


def test_spade_ldm_recipe_main_at_a_tiny_size():
    out = tldm.main(["--device", "cpu", "--stage1-steps", "2", "--warmup-steps", "1",
                     "--stage2-steps", "2", "--batch", "2", "--size", "32"])
    losses = [v for step in out["stage1_losses"] for v in step.values()] + out["stage2_losses"]
    assert len(losses) == 8 and all(math.isfinite(v) for v in losses)
    assert math.isfinite(out["scale_factor"]) and out["sample"] is None
    assert out["unet"].label_nc == out["aekl"].label_nc == LABEL_NC


def test_spade_recipes_run_on_the_cpu_only_when_asked():
    """`--device` defaults to cuda: without a GPU each recipe raises; with
    `--device cpu` it runs (above)."""
    assert tldm.build_argparser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tldm.main(["--stage1-steps", "0", "--stage2-steps", "0"])
        with pytest.raises(RuntimeError):
            tvae.main(["--steps", "0"])


def test_decode_passes_seg_only_to_a_spade_autoencoder(models):
    """`_decode` hands `seg` to an autoencoder with `label_nc` and to no
    other; without a seg it decodes as before (the latent bench's split
    timing calls it so)."""
    _, _, stage1 = models["port"]
    z, seg = torch.from_numpy(rand(LATENT, 16)), torch.from_numpy(segmap(17))
    inferer = LatentDiffusionInferer(tsched.DDIMScheduler(num_train_timesteps=1000),
                                     scale_factor=0.5)
    with torch.no_grad():
        assert_close(inferer._decode(stage1, z, seg), stage1.decode_stage_2_outputs(z / 0.5, seg))

    class Plain:
        def decode_stage_2_outputs(self, latent):
            return 2 * latent

    torch.testing.assert_close(inferer._decode(Plain(), z), 4 * z)
    torch.testing.assert_close(inferer._decode(Plain(), z, seg), 4 * z)
