"""The port's EMAQuantizer, VectorQuantizer and VQVAE against the JAX modules.

Every JAX parameter and codebook leaf is drawn from a numpy seed and carried
to the port by `vqvae_state_dict_from_jax`; both sides see the same numpy
input. Tolerances:
- the quantizers: the quantized output, the commitment loss and the three
  codebook buffers after one and after two train calls at rtol 1e-5 (and
  atol 1e-6 for buffer entries near 0). Indices are compared where the
  nearest code leads the second by more than the float32 rounding of the
  distance (8 ulps of |x|^2 + |e|^2); the test counts such near-ties and
  leaves them, and the codes they touch, out of the comparison;
- the VQVAE's outputs (forward, encode, decode, index_quantize,
  decode_samples, the stage-2 pair), 2D and 3D: 1e-5 of the largest output
  (f32 convolution sums in another order);
- parameter gradients (f32): rtol 1e-4 and atol 1e-4 of each parameter's
  largest gradient, floor 1e-6, as tests/test_torch_train.py holds them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.layers.vector_quantizer import EMAQuantizer as JaxEMA
from generativemodels_tpu.networks.nets import VQVAE as JaxVQVAE
from generativemodels_tpu_torch.networks import vqvae_state_dict_from_jax
from generativemodels_tpu_torch.networks.layers import EMAQuantizer, VectorQuantizer
from generativemodels_tpu_torch.networks.nets import VQVAE
from tests.test_torch_unet import random_params

RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6
BATCH = 2
K, D = 16, 4
SMALL = dict(
    in_channels=1, out_channels=1, num_channels=(8, 16), num_res_layers=1,
    num_res_channels=(8, 16), downsample_parameters=((2, 4, 1, 1), (2, 4, 1, 1)),
    upsample_parameters=((2, 4, 1, 1, 0), (2, 4, 1, 1, 0)), num_embeddings=K,
    embedding_dim=D, decay=0.9,
)
# (spatial_dims, overrides, input edge)
CASES = {
    "2d": (2, {}, 16),
    # stride 1 with dilation 2 on the second level, both ways
    "2d_dilated": (2, dict(downsample_parameters=((2, 4, 1, 1), (1, 3, 2, 2)),
                           upsample_parameters=((1, 3, 2, 2, 0), (2, 4, 1, 1, 0))), 16),
    "3d": (3, {}, 8),
}


def random_codebook(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    embedding = rng.standard_normal((K, D)).astype(np.float32)
    return {"embedding": embedding,
            "ema_cluster_size": rng.uniform(0.5, 2.0, K).astype(np.float32),
            "ema_w": (embedding * rng.uniform(0.5, 2.0, (K, 1))).astype(np.float32)}


def near_ties(x_cl: np.ndarray, embedding: np.ndarray) -> np.ndarray:
    """Rows of x (channels-last, flattened) whose two nearest codes are
    closer than the float32 rounding of their distance; and the codes
    they touch."""
    flat = x_cl.reshape(-1, D).astype(np.float64)
    e = embedding.astype(np.float64)
    dist = (flat**2).sum(1, keepdims=True) + (e**2).sum(1)[None] - 2 * flat @ e.T
    order = np.argsort(dist, axis=1)
    rows = np.arange(len(flat))
    gap = dist[rows, order[:, 1]] - dist[rows, order[:, 0]]
    scale = (flat**2).sum(1) + (e**2).sum(1)[order[:, 0]]
    tie = gap <= 8 * np.finfo(np.float32).eps * scale
    return tie, set(order[tie, :2].ravel().tolist())


def build_vq_pair(cfg: dict, size: int, seed: int = 0):
    """(JAX model, params, codebook, port model with the same weights)."""
    jmodel = JaxVQVAE(**cfg)
    x = jnp.zeros((BATCH, 1) + (size,) * cfg["spatial_dims"])
    struct = zoo_convert.variables_structure(jmodel, x)
    params = random_params(struct["params"], seed)
    codebook = {"quantizer": {"quantizer": random_codebook(seed + 100)}}
    port = VQVAE(**cfg)
    port.load_state_dict(vqvae_state_dict_from_jax(
        params, codebook, port.state_dict(), cfg["num_channels"], cfg["num_res_layers"]),
        strict=True)
    return jmodel, params, codebook, port


def image(spatial_dims: int, size: int, seed: int = 1) -> np.ndarray:
    shape = (BATCH, 1) + (size,) * spatial_dims
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def assert_close(got, want, rtol: float = RTOL) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3  # the check is not empty
    assert float(np.abs(got - want).max()) <= rtol * scale


def config(name: str) -> tuple[dict, int]:
    spatial_dims, overrides, size = CASES[name]
    return dict(SMALL, spatial_dims=spatial_dims, **overrides), size


@pytest.mark.parametrize("spatial_dims", [2, 3], ids=["2d", "3d"])
def test_ema_quantizer_matches_jax(spatial_dims):
    """Eval, then two train calls: outputs and the codebook buffers."""
    jq = JaxEMA(spatial_dims=spatial_dims, num_embeddings=K, embedding_dim=D, decay=0.9)
    cb = random_codebook(3)
    port = EMAQuantizer(spatial_dims, K, D, decay=0.9)
    port.load_state_dict({"embedding.weight": torch.from_numpy(cb["embedding"]),
                          "ema_cluster_size": torch.from_numpy(cb["ema_cluster_size"]),
                          "ema_w": torch.from_numpy(cb["ema_w"])}, strict=True)
    rng = np.random.RandomState(4)
    variables = {"codebook": {k: jnp.asarray(v) for k, v in cb.items()}}
    ties_seen = 0
    for call, train in enumerate((False, True, True)):
        x = rng.standard_normal((BATCH, D) + (4,) * spatial_dims).astype(np.float32)
        x_cl = np.moveaxis(x, 1, -1)
        tie, tied_codes = near_ties(x_cl, np.asarray(variables["codebook"]["embedding"]))
        ties_seen += int(tie.sum())
        (jquant, jloss, jidx), mutated = jq.apply(variables, jnp.asarray(x_cl), train=train,
                                                  mutable=["codebook"])
        quant, loss, idx = port(torch.from_numpy(x), train=train)
        keep = ~tie
        np.testing.assert_array_equal(idx.numpy().reshape(-1)[keep],
                                      np.asarray(jidx).reshape(-1)[keep])
        q_port = np.moveaxis(quant.numpy(), 1, -1).reshape(-1, D)[keep]
        np.testing.assert_allclose(q_port, np.asarray(jquant).reshape(-1, D)[keep], rtol=RTOL)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
        variables = {"codebook": mutated["codebook"]}
        codes = [c for c in range(K) if c not in tied_codes]
        for name, buf in (("embedding", port.embedding.weight),
                          ("ema_cluster_size", port.ema_cluster_size), ("ema_w", port.ema_w)):
            np.testing.assert_allclose(buf.numpy()[codes],
                                       np.asarray(variables["codebook"][name])[codes],
                                       rtol=RTOL, atol=1e-6, err_msg=f"call {call}: {name}")
    assert ties_seen <= 1  # near-ties are rare at these sizes: the comparison is not empty


def test_vector_quantizer_perplexity_matches_jax():
    from generativemodels_tpu.networks.layers.vector_quantizer import VectorQuantizer as JaxVQ

    cb = random_codebook(5)
    jvq = JaxVQ(quantizer=JaxEMA(spatial_dims=2, num_embeddings=K, embedding_dim=D))
    port = VectorQuantizer(EMAQuantizer(2, K, D))
    port.quantizer.load_state_dict({"embedding.weight": torch.from_numpy(cb["embedding"]),
                                    "ema_cluster_size": torch.from_numpy(cb["ema_cluster_size"]),
                                    "ema_w": torch.from_numpy(cb["ema_w"])})
    x = np.random.RandomState(6).standard_normal((BATCH, D, 6, 6)).astype(np.float32)
    (jloss, jquant), state = jvq.apply(
        {"codebook": {"quantizer": {k: jnp.asarray(v) for k, v in cb.items()}}},
        jnp.asarray(np.moveaxis(x, 1, -1)), mutable=["codebook", "metrics"])
    loss, quant = port(torch.from_numpy(x), train=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(port.perplexity),
                               float(state["metrics"]["perplexity"][0]), rtol=RTOL)
    np.testing.assert_array_equal(port.quantize(torch.from_numpy(x)).numpy(),
                                  np.asarray(jvq.apply(
                                      {"codebook": {"quantizer": cb}},
                                      jnp.asarray(np.moveaxis(x, 1, -1)),
                                      method=JaxVQ.quantize)))


@pytest.mark.parametrize("name", list(CASES))
def test_vqvae_forward_matches_jax(name):
    """Eval and one train call (the codebook moves in both packages alike)."""
    cfg, size = config(name)
    jmodel, params, codebook, port = build_vq_pair(cfg, size)
    x = image(cfg["spatial_dims"], size)
    for train in (False, True):
        (jrecon, jloss), mutated = jmodel.apply(
            {"params": params, "codebook": codebook}, jnp.asarray(x), train=train,
            mutable=["codebook", "metrics"])
        port.train(train)
        with torch.no_grad():
            recon, loss = port(torch.from_numpy(x))
        assert_close(recon.numpy(), jrecon)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
        want = mutated["codebook"]["quantizer"]["quantizer"]
        assert_close(port.quantizer.quantizer.embedding.weight.numpy(), want["embedding"])
        assert_close(port.quantizer.quantizer.ema_w.numpy(), want["ema_w"])
        codebook = mutated["codebook"]


@pytest.mark.parametrize("name", ["2d", "3d"])
def test_vqvae_methods_match_jax(name):
    """encode / decode / index_quantize / decode_samples / the stage-2 pair."""
    cfg, size = config(name)
    jmodel, params, codebook, port = build_vq_pair(cfg, size, seed=7)
    port.eval()
    variables = {"params": params, "codebook": codebook}
    x = image(cfg["spatial_dims"], size, seed=8)

    def jax_call(method, *args, **kwargs):
        return jmodel.apply(variables, *map(jnp.asarray, args), method=method, **kwargs)

    with torch.no_grad():
        tx = torch.from_numpy(x)
        z = port.encode(tx)
        assert_close(z.numpy(), jax_call(JaxVQVAE.encode, x))
        assert_close(port.decode(z).numpy(), jax_call(JaxVQVAE.decode, z.numpy()))
        idx = port.index_quantize(tx)
        jidx = np.asarray(jax_call(JaxVQVAE.index_quantize, x))
        tie, _ = near_ties(np.moveaxis(z.numpy(), 1, -1),
                           codebook["quantizer"]["quantizer"]["embedding"])
        assert not tie.any()
        np.testing.assert_array_equal(idx.numpy(), jidx)
        assert_close(port.decode_samples(idx).numpy(),
                     jax_call(JaxVQVAE.decode_samples, jidx))
        for quantized in (True, False):
            assert_close(port.encode_stage_2_inputs(tx, quantized=quantized).numpy(),
                         jax_call(JaxVQVAE.encode_stage_2_inputs, x, quantized=quantized))
        assert_close(port.decode_stage_2_outputs(z).numpy(),
                     jax_call(JaxVQVAE.decode_stage_2_outputs, z.numpy()))
    # the stage-2 pair never moves the codebook, even in training mode
    before = port.quantizer.quantizer.embedding.weight.clone()
    port.train()
    with torch.no_grad():
        port.encode_stage_2_inputs(tx)
    torch.testing.assert_close(port.quantizer.quantizer.embedding.weight, before, rtol=0, atol=0)


def _grads_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=GRAD_TOL,
                                   atol=max(GRAD_TOL * np.abs(w).max(), GRAD_FLOOR),
                                   err_msg=name)


@pytest.mark.parametrize("name", ["2d_dilated", "3d"])
def test_vqvae_gradients_match_jax(name):
    """d(sum(recon * g) + loss) / d(params) in train mode: the straight-through
    estimator and the commitment loss included."""
    cfg, size = config(name)
    jmodel, params, codebook, port = build_vq_pair(cfg, size, seed=9)
    x = image(cfg["spatial_dims"], size, seed=10)
    g = np.random.RandomState(11).standard_normal(x.shape).astype(np.float32)

    def f(p):
        (recon, loss), _ = jmodel.apply({"params": p, "codebook": codebook}, jnp.asarray(x),
                                        train=True, mutable=["codebook", "metrics"])
        return jnp.sum(recon * jnp.asarray(g)) + loss

    jgrads = jax.grad(f)(params)
    want = {k: v.numpy() for k, v in vqvae_state_dict_from_jax(
        jgrads, codebook, port.state_dict(), cfg["num_channels"],
        cfg["num_res_layers"]).items() if not k.startswith("quantizer.")}
    port.train()
    recon, loss = port(torch.from_numpy(x))
    ((recon * torch.from_numpy(g)).sum() + loss).backward()
    _grads_close({n: p.grad.numpy() for n, p in port.named_parameters()}, want)


def test_vqvae_rejects_bad_sampling_parameters():
    with pytest.raises(ValueError, match="4 integers"):
        VQVAE(2, 1, 1, num_channels=(8,), num_res_channels=(8,),
              downsample_parameters=((2, 4, 1),), upsample_parameters=((2, 4, 1, 1, 0),))
    with pytest.raises(ValueError, match="same length"):
        VQVAE(2, 1, 1, num_channels=(8, 8), num_res_channels=(8, 8),
              downsample_parameters=((2, 4, 1, 1),) * 3, upsample_parameters=(2, 4, 1, 1, 0))


@pytest.mark.parametrize("quantized", [True, False], ids=["quantized", "continuous"])
def test_latent_inferer_with_vqvae_matches_jax(quantized):
    """LatentDiffusionInferer's training call (a small latent UNet) and its
    DDIM-5 sample (test_torch_latent.py's smooth stand-in model, so that the
    chain holds to f32 rounding) with the VQ-VAE as stage 1, `quantized`
    reaching its encode; 1e-5 of the largest output."""
    from generativemodels_tpu.inferers import LatentDiffusionInferer as JaxLatentInferer
    from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
    from generativemodels_tpu_torch.inferers import LatentDiffusionInferer
    from generativemodels_tpu_torch.networks import unet_state_dict_from_jax
    from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
    from tests.test_torch_latent import SMOOTH, schedulers

    cfg, size = config("2d")
    jmodel, params, codebook, port = build_vq_pair(cfg, size, seed=12)
    port.eval()
    stage1 = jmodel.bind({"params": params, "codebook": codebook})
    unet_cfg = dict(spatial_dims=2, in_channels=D, out_channels=D, num_res_blocks=1,
                    num_channels=(8, 16), attention_levels=(False, False), norm_num_groups=4)
    junet = JaxUNet(**unet_cfg)
    latent = (BATCH, D, size // 4, size // 4)
    u_params = random_params(zoo_convert.params_structure(
        junet, jnp.zeros(latent), jnp.zeros((BATCH,), jnp.int32)), 13)
    unet = DiffusionModelUNet(**unet_cfg)
    unet.load_state_dict(unet_state_dict_from_jax(u_params, unet.state_dict()), strict=True)
    x = image(2, size, seed=14)
    noise = np.random.RandomState(15).standard_normal(latent).astype(np.float32)
    timesteps = np.array([10, 700])

    jsch, tsch = schedulers("DDIMScheduler", 5)
    want = JaxLatentInferer(jsch, scale_factor=0.5)(
        jnp.asarray(x), stage1, lambda z, t, context=None: junet.apply({"params": u_params}, z, t),
        jnp.asarray(noise), jnp.asarray(timesteps), quantized=quantized)
    inferer = LatentDiffusionInferer(tsch, scale_factor=0.5)
    with torch.no_grad():
        got = inferer(torch.from_numpy(x), port, lambda z, t, context=None: unet(z, t),
                      torch.from_numpy(noise), torch.from_numpy(timesteps), quantized=quantized)
        assert_close(got.numpy(), want)
        jfn, tfn = SMOOTH["epsilon"]
        j_img = JaxLatentInferer(jsch, scale_factor=0.5).sample(jnp.asarray(noise), stage1, jfn)
        t_img = inferer.sample(torch.from_numpy(noise), port, tfn)
    assert t_img.shape == x.shape
    assert_close(t_img.numpy(), j_img)
