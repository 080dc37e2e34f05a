"""The port's VQVAETransformerInferer, resolve_use_cache and the VQ-VAE +
transformer recipe against the JAX package.

The VQ-VAE and the transformer carry the same weights on both sides (drawn
from numpy seeds, carried by the converters); the inputs are the same numpy
arrays. Tolerances:
- logits and log-likelihood maps (f32): 1e-5 of the largest value;
- sampled tokens: equal, on greedy (`top_k=1`) chains, where no random draw
  enters; a step whose top-2 logit gap is under GAP_TOL (JAX's own logits)
  is a near-tie that f32 rounding may break either way, and is compared
  step by step instead (the port's choice given JAX's prefix);
- the categorical draw: each token's frequency over 40000 draws within
  0.012 of its softmax probability (over 4 standard deviations).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.inferers import VQVAETransformerInferer as JaxInferer
from generativemodels_tpu.inferers.vqvae_transformer import (
    resolve_use_cache as jax_resolve_use_cache,
)
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import DecoderOnlyTransformer as JaxTransformer
from generativemodels_tpu.utils.ordering import Ordering as JaxOrdering
from generativemodels_tpu_torch.inferers import VQVAETransformerInferer, resolve_use_cache
from generativemodels_tpu_torch.inferers.vqvae_transformer import _draw
from generativemodels_tpu_torch.networks import transformer_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets import DecoderOnlyTransformer
from generativemodels_tpu_torch.recipes import train_vqvae_transformer as trecipe
from generativemodels_tpu_torch.utils import Ordering
from tests.test_torch_unet import random_params
from tests.test_torch_vqvae import SMALL, build_vq_pair
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
GAP_TOL = 1e-4
K = SMALL["num_embeddings"]  # 16 codes; BOS is K
SIZE, GRID = 16, (4, 4)  # two stride-2 levels: a 4x4 token grid
SEQ = GRID[0] * GRID[1]
B = 2


def assert_close(got, want, rtol: float = RTOL) -> None:
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    assert float(np.abs(got - want).max()) <= rtol * scale


def transformer_pair(max_seq_len: int, seed: int = 0, dim: int = 16, sharp: bool = True):
    """(bound JAX transformer, port transformer) with the same weights;
    `sharp`: BOS never leads, as in a trained model (with top_k=1 a leading
    BOS would leave nothing to draw); else the weights as drawn (for
    likelihoods, where a BOS bias of -1e4 would only add an exact 0)."""
    cfg = dict(num_tokens=K + 1, max_seq_len=max_seq_len, attn_layers_dim=dim,
               attn_layers_depth=2, attn_layers_heads=2)
    jmodel = JaxTransformer(**cfg)
    params = random_params(zoo_convert.params_structure(
        jmodel, jnp.zeros((1, max_seq_len), jnp.int32)), seed)
    if sharp:
        params["to_logits"]["bias"][K] = -1e4
    port = DecoderOnlyTransformer(**cfg).eval()
    port.load_state_dict(transformer_state_dict_from_jax(params, port.state_dict()), strict=True)
    return jmodel.bind({"params": params}), port


@pytest.fixture(scope="module")
def vq():
    cfg = dict(SMALL, spatial_dims=2)
    jmodel, params, codebook, port = build_vq_pair(cfg, SIZE, seed=1)
    return jmodel.bind({"params": params, "codebook": codebook}), port.eval()


def images(seed: int = 2, batch: int = B) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal((batch, 1, SIZE, SIZE)).astype(np.float32)


def orderings(kind: str = "s_curve"):
    return JaxOrdering(kind, 2, (1,) + GRID), Ordering(kind, 2, (1,) + GRID)


class TokenGrid:
    """A stand-in VQ-VAE: `index_quantize` gives a fixed token grid whatever
    the image, `decode_samples` the tokens themselves."""

    num_embeddings = K

    def __init__(self, grid: np.ndarray, framework: str) -> None:
        self.grid = grid
        self.framework = framework

    def index_quantize(self, inputs):
        batch = inputs.shape[0]
        grid = np.broadcast_to(self.grid, (batch,) + self.grid.shape[1:]).copy()
        return jnp.asarray(grid) if self.framework == "jax" else torch.from_numpy(grid).long()

    def decode_samples(self, latent):
        return latent


def test_training_forward_matches_jax(vq):
    jvq, tvq = vq
    jtr, ttr = transformer_pair(SEQ)
    jord, tord = orderings()
    x = images()
    want, want_target, want_dims = JaxInferer()(jnp.asarray(x), jvq, jtr, jord,
                                                return_latent=True)
    got, target, dims = VQVAETransformerInferer()(torch.from_numpy(x), tvq, ttr, tord,
                                                   return_latent=True)
    assert dims == want_dims == GRID
    np.testing.assert_array_equal(target.numpy(), np.asarray(want_target))
    assert_close(got.detach(), want)
    plain = VQVAETransformerInferer()(torch.from_numpy(x), tvq, ttr, tord)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


def test_training_crop_matches_jax_at_the_same_start(vq):
    """max_seq_len < seq_len: the crop's start comes from the generator;
    JAX is given a key that draws the same start."""
    jvq, tvq = vq
    max_len = 10
    jtr, ttr = transformer_pair(max_len, seed=3)
    jord, tord = orderings("raster_scan")
    x = images(4)
    choices = SEQ + 1 - max_len
    start = int(torch.randint(0, choices, (), generator=torch.Generator().manual_seed(5)))
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(1000))
               if int(jax.random.randint(k, (), 0, choices)) == start)
    want, want_target, _ = JaxInferer()(jnp.asarray(x), jvq, jtr, jord, return_latent=True,
                                        key=key)
    got, target, _ = VQVAETransformerInferer()(
        torch.from_numpy(x), tvq, ttr, tord, return_latent=True,
        generator=torch.Generator().manual_seed(5))
    assert got.shape == (B, max_len, K + 1)
    np.testing.assert_array_equal(target.numpy(), np.asarray(want_target))
    assert_close(got.detach(), want)
    with pytest.raises(ValueError, match="generator"):
        VQVAETransformerInferer()(torch.from_numpy(x), tvq, ttr, tord)


def _greedy_chains(jtr, ttr, max_seq_len: int, use_cache: bool):
    """(JAX tokens, the port's tokens, JAX's top-2 gaps along its chain, the
    port's greedy choice at each step given JAX's prefix)."""
    jord, tord = orderings()
    stub_j = TokenGrid(np.zeros((1,) + GRID, np.int32), "jax")
    stub_t = TokenGrid(np.zeros((1,) + GRID, np.int32), "torch")
    start = np.array([[K], [5]], np.int32)  # BOS, and a prompt token
    want = np.asarray(JaxInferer().sample(GRID, jnp.asarray(start), stub_j, jtr, jord, top_k=1,
                                          use_cache=use_cache))
    got = VQVAETransformerInferer().sample(GRID, torch.from_numpy(start).long(), stub_t, ttr,
                                           tord, top_k=1, use_cache=use_cache).numpy()
    # JAX's chain in sampling order, after BOS, and the logits along it
    seq = np.concatenate([start, want.reshape(B, -1)[:, jord.get_sequence_ordering()]], axis=1)
    if max_seq_len >= SEQ:  # every window is a prefix: one causal forward gives all
        jl = np.asarray(jtr(jnp.asarray(seq[:, :SEQ])))
        with torch.no_grad():
            tl = ttr(torch.from_numpy(seq[:, :SEQ]).long()).numpy()
    else:
        jl, tl = [], []
        for pos in range(1, SEQ + 1):
            window = seq[:, max(0, pos - max_seq_len):pos]
            jl.append(np.asarray(jtr(jnp.asarray(window)))[:, -1])
            with torch.no_grad():
                tl.append(ttr(torch.from_numpy(window).long())[:, -1].numpy())
        jl, tl = np.stack(jl, 1), np.stack(tl, 1)
    jl, tl = jl[..., :K], tl[..., :K]
    top2 = np.sort(jl, axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    return want, got, gaps, seq[:, 1:], np.argmax(tl, axis=-1)


@pytest.mark.parametrize("path", ["windowed", "cached", "cropped_window"])
def test_greedy_sample_matches_jax(path):
    max_len = {"windowed": SEQ, "cached": SEQ + 1, "cropped_window": 6}[path]
    jtr, ttr = transformer_pair(max_len, seed=6)
    want, got, gaps, jax_seq, port_choice = _greedy_chains(jtr, ttr, max_len, path == "cached")
    ties = gaps <= GAP_TOL
    if not ties.any():
        np.testing.assert_array_equal(got, want)
    # step by step: the port's greedy choice given JAX's prefix, off near-ties
    assert (port_choice[~ties] == jax_seq[~ties]).all()


def test_greedy_windowed_and_cached_chains_are_equal():
    jtr, ttr = transformer_pair(SEQ + 1, seed=7)
    jord, tord = orderings()
    stub = TokenGrid(np.zeros((1,) + GRID, np.int32), "torch")
    start = torch.full((B, 1), K)
    a = VQVAETransformerInferer().sample(GRID, start, stub, ttr, tord, top_k=1, use_cache=False)
    b = VQVAETransformerInferer().sample(GRID, start, stub, ttr, tord, top_k=1, use_cache=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sampling_draws_from_the_generator():
    _, ttr = transformer_pair(SEQ + 1, seed=8, sharp=False)
    _, tord = orderings()
    stub = TokenGrid(np.zeros((1,) + GRID, np.int32), "torch")
    start = torch.full((B, 1), K)

    def run(seed, use_cache, **kw):
        return VQVAETransformerInferer().sample(
            GRID, start, stub, ttr, tord, generator=torch.Generator().manual_seed(seed),
            use_cache=use_cache, **kw)

    for use_cache in (False, True):
        torch.testing.assert_close(run(1, use_cache), run(1, use_cache), rtol=0, atol=0)
        assert not torch.equal(run(1, use_cache), run(2, use_cache))
        assert (run(3, use_cache, top_k=3, temperature=0.5) < K).all()  # BOS never drawn
    # the same draws on both paths: the logits agree to rounding, the noise is shared
    torch.testing.assert_close(run(4, False), run(4, True), rtol=0, atol=0)
    # the default generator is seeded 0 on the tokens' device
    default = VQVAETransformerInferer().sample(GRID, start, stub, ttr, tord)
    torch.testing.assert_close(default, run(0, None), rtol=0, atol=0)


def test_categorical_draw_statistics():
    n, v = 40000, 6
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, 0.5, 3.0])
    rows = logits.expand(n, v)
    g = torch.Generator().manual_seed(0)
    drawn = _draw(rows, 1.0, None, v - 1, g)
    freq = torch.bincount(drawn, minlength=v).double() / n
    p = torch.softmax(logits[:-1].double(), 0)  # the last token is BOS, masked
    assert freq[-1] == 0
    assert float((freq[:-1] - p).abs().max()) <= 0.012
    top2 = _draw(rows, 1.0, 3, v - 1, g)  # top 3 includes BOS: two real tokens stay
    assert set(torch.unique(top2).tolist()) == {0, 3}


@pytest.mark.parametrize("max_len", [SEQ, 9], ids=["one_pass", "windowed"])
def test_likelihood_matches_jax(vq, max_len):
    jvq, tvq = vq
    jtr, ttr = transformer_pair(max_len, seed=9, sharp=False)
    jord, tord = orderings()
    x = images(10)
    want = JaxInferer().get_likelihood(jnp.asarray(x), jvq, jtr, jord)
    got = VQVAETransformerInferer().get_likelihood(torch.from_numpy(x), tvq, ttr, tord)
    assert got.shape == (B,) + GRID
    assert_close(got, want)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("image_shape", [(16, 16), (7, 11)], ids=["ratio_4", "uneven"])
def test_resampled_likelihood_matches_jax(mode, image_shape):
    """The map resampled to the image's shape, at an integer and an uneven
    ratio: JAX's jax.image.resize conventions (nearest with half-pixel
    centres, linear with align_corners=False)."""
    jtr, ttr = transformer_pair(SEQ, seed=11, sharp=False)
    jord, tord = orderings("raster_scan")
    grid = np.random.RandomState(12).randint(0, K, (1,) + GRID).astype(np.int32)
    x = np.zeros((B, 1) + image_shape, np.float32)
    want = JaxInferer().get_likelihood(
        jnp.asarray(x), TokenGrid(grid, "jax"), jtr, jord, resample_latent_likelihoods=True,
        resample_interpolation_mode=mode)
    got = VQVAETransformerInferer().get_likelihood(
        torch.from_numpy(x), TokenGrid(grid, "torch"), ttr, tord,
        resample_latent_likelihoods=True, resample_interpolation_mode=mode)
    assert got.shape == (B, 1) + image_shape
    assert_close(got, want)
    with pytest.raises(ValueError):
        VQVAETransformerInferer().get_likelihood(
            torch.from_numpy(x), TokenGrid(grid, "torch"), ttr, tord,
            resample_latent_likelihoods=True, resample_interpolation_mode="bicubic")


def test_resolve_use_cache_cases():
    jtr, ttr = transformer_pair(SEQ + 1, seed=13)
    for total, max_len, bos in ((17, 17, 1), (17, 16, 1), (17, 17, 2), (5, 17, 1)):
        assert resolve_use_cache(total, max_len, bos, ttr) == jax_resolve_use_cache(
            total, max_len, bos, jtr)
    assert resolve_use_cache(17, 17, 1, ttr)  # fits, on the CPU
    assert not resolve_use_cache(17, 17, 1, lambda x, context=None: x)  # no cache to unbind


def test_recipe_main_at_a_tiny_size():
    out = trecipe.main(["--device", "cpu", "--stage1-steps", "2", "--stage2-steps", "2",
                        "--batch", "2", "--size", "16", "--num-embeddings", "8"])
    losses = out["stage1_losses"] + out["stage2_losses"] + out["perplexities"]
    assert len(losses) == 6 and all(math.isfinite(v) for v in losses)
    assert out["likelihood"].shape == (2, 4, 4)
    assert bool(torch.isfinite(out["likelihood"]).all()) and float(out["likelihood"].max()) <= 0
    assert out["transformer"].max_seq_len == 16 and out["vqvae"].num_embeddings == 8


def test_recipe_runs_on_the_cpu_only_when_asked():
    """`--device` defaults to cuda: without a GPU the recipe raises, and it
    runs on the CPU when asked (above)."""
    assert trecipe.build_argparser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            trecipe.main(["--stage1-steps", "0", "--stage2-steps", "0"])
