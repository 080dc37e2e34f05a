"""The port's ConvTransposeND and AutoencoderKL against the JAX modules.

Every JAX parameter is drawn from a numpy seed and carried to the port by
`autoencoderkl_state_dict_from_jax`; both sides see the same numpy input.
Tolerances: in f32, max|diff| <= 1e-5 of max|JAX output| (convolution sums
and GroupNorm statistics in another order); in bf16, the port's distance
from the JAX bf16 output at most twice the JAX bf16 output's own distance
from the JAX f32 output (both round to bf16 after every layer, at places
that differ by the order of their f32 sums).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.blocks.convolutions import ConvTransposeND as JaxConvT
from generativemodels_tpu.networks.nets import AutoencoderKL as JaxAEKL
from generativemodels_tpu_torch.networks import autoencoderkl_state_dict_from_jax
from generativemodels_tpu_torch.networks.blocks import ConvTransposeND
from generativemodels_tpu_torch.networks.nets import AutoencoderKL
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
BF16_RATIO = 2.0
BATCH = 2
SMALL = dict(
    in_channels=1, out_channels=1, num_res_blocks=1, num_channels=(8, 16, 16),
    attention_levels=(False, False, False), latent_channels=3, norm_num_groups=4,
    with_encoder_nonlocal_attn=False, with_decoder_nonlocal_attn=False,
)
# (spatial_dims, overrides, input size)
CASES = {
    "2d_attention": (2, dict(attention_levels=(False, False, True),
                             with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True),
                     32),
    "2d_convtranspose": (2, dict(use_convtranspose=True, num_res_blocks=(1, 2, 1)), 32),
    "3d": (3, {}, 16),
}


def random_params(struct, seed: int) -> dict:
    """Every leaf drawn from a numpy seed: kernels at 1/sqrt(fan_in),
    GroupNorm scales around 1, biases small."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            r = r / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            r = 1.0 + 0.1 * r
        else:
            r = 0.1 * r
        return r.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, struct)


def config(spatial_dims: int, **overrides) -> dict:
    return dict(SMALL, spatial_dims=spatial_dims, **overrides)


def build_pair(cfg: dict, size: int, seed: int = 0, dtype=None):
    """(JAX model, numpy params, port model with the same weights)."""
    jmodel = JaxAEKL(**cfg, dtype=None if dtype is None else jnp.bfloat16)
    x = jnp.zeros((BATCH, 1) + (size,) * cfg["spatial_dims"])
    struct = zoo_convert.params_structure(jmodel, x, method=JaxAEKL.reconstruct)
    params = random_params(struct, seed)
    port = AutoencoderKL(**cfg, dtype=dtype)
    state = autoencoderkl_state_dict_from_jax(
        params, port.state_dict(), cfg["num_channels"], cfg["num_res_blocks"],
        cfg["attention_levels"], cfg["with_encoder_nonlocal_attn"],
        cfg["with_decoder_nonlocal_attn"], cfg.get("use_convtranspose", False),
    )
    port.load_state_dict(state, strict=True)
    return jmodel, params, port.eval()


def image(cfg: dict, size: int, seed: int = 1) -> np.ndarray:
    shape = (BATCH, 1) + (size,) * cfg["spatial_dims"]
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def run_both(jmodel, params, port, method: str, *args):
    """The outputs of `method` on both sides, as lists of numpy arrays."""
    j_out = jmodel.apply({"params": params}, *map(jnp.asarray, args),
                         method=getattr(JaxAEKL, method))
    with torch.no_grad():
        t_out = getattr(port, method)(*map(torch.from_numpy, args))
    if not isinstance(j_out, tuple):
        j_out, t_out = (j_out,), (t_out,)
    return [np.asarray(a) for a in j_out], [b.float().numpy() for b in t_out]


def assert_close(got: np.ndarray, want: np.ndarray, rtol: float = RTOL) -> None:
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-2  # the check is not empty
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("spatial_dims, size", [(2, 9), (3, 5)], ids=["2d", "3d"])
def test_conv_transpose_matches_jax(spatial_dims, size):
    """stride 2, padding 1, output_padding 1: the JAX kernel (*k, I, O),
    transposed to torch's (I, O, *k) and flipped on every spatial axis."""
    jconv = JaxConvT(spatial_dims, 6, kernel_size=3, strides=2, padding=1, output_padding=1)
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2,) + (size,) * spatial_dims + (4,)).astype(np.float32)
    struct = zoo_convert.params_structure(jconv, jnp.asarray(x))
    params = random_params(struct, 3)
    want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))

    port = ConvTransposeND(spatial_dims, 4, 6, kernel_size=3, strides=2, padding=1,
                           output_padding=1)
    kernel = np.transpose(params["kernel"], (spatial_dims, spatial_dims + 1,
                                             *range(spatial_dims)))
    kernel = np.flip(kernel, tuple(range(2, kernel.ndim))).copy()
    port.conv.weight.data = torch.from_numpy(kernel)
    port.conv.bias.data = torch.from_numpy(params["bias"])
    with torch.no_grad():
        got = port(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    assert got.shape[2:] == (2 * size,) * spatial_dims
    assert_close(np.moveaxis(got, 1, -1), want)


@pytest.mark.parametrize("case", list(CASES))
def test_encode_decode_reconstruct_match_jax(case):
    spatial_dims, overrides, size = CASES[case]
    cfg = config(spatial_dims, **overrides)
    jmodel, params, port = build_pair(cfg, size)
    x = image(cfg, size)
    j_enc, t_enc = run_both(jmodel, params, port, "encode", x)
    latent = (size // 4,) * spatial_dims
    for got, want in zip(t_enc, j_enc):
        assert got.shape == (BATCH, 3) + latent
        assert_close(got, want)
    z = np.random.RandomState(2).standard_normal((BATCH, 3) + latent).astype(np.float32)
    for method, arg in (("decode", z), ("reconstruct", x)):
        (want,), (got,) = run_both(jmodel, params, port, method, arg)
        assert got.shape == x.shape
        assert_close(got, want)


def test_bf16_matches_jax_within_its_own_rounding():
    cfg = config(2, attention_levels=(False, False, True), with_decoder_nonlocal_attn=True)
    x = image(cfg, 32)
    j32, params, _ = build_pair(cfg, 32)
    j16, _, port = build_pair(cfg, 32, dtype=torch.bfloat16)
    for method in ("encode", "reconstruct"):
        want = jax.tree_util.tree_leaves(
            j32.apply({"params": params}, jnp.asarray(x), method=getattr(JaxAEKL, method)))
        j_bf16, t_bf16 = run_both(j16, params, port, method, x)
        for w, jb, tb in zip(want, j_bf16, t_bf16):
            w = np.asarray(w)
            own = float(np.abs(jb - w).max())
            assert own > 0  # bf16 rounding shows
            assert float(np.abs(tb - jb).max()) <= BF16_RATIO * own


def test_state_dict_round_trips_through_zoo_convert():
    """port.state_dict() -> the JAX package's converter gives back exactly
    the JAX params the port was loaded from (transposed convs too)."""
    spatial_dims, overrides, size = CASES["2d_convtranspose"]
    cfg = config(spatial_dims, **overrides)
    jmodel, params, port = build_pair(cfg, size, seed=5)
    struct = zoo_convert.params_structure(
        jmodel, jnp.zeros((BATCH, 1, size, size)), method=JaxAEKL.reconstruct)
    back = zoo_convert.convert_autoencoderkl(
        port.state_dict(), struct, cfg["num_channels"], cfg["num_res_blocks"],
        cfg["attention_levels"], cfg["with_encoder_nonlocal_attn"],
        cfg["with_decoder_nonlocal_attn"], use_convtranspose=True,
    )
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)


def _drop(params):
    params = jax.tree_util.tree_map(lambda a: a, params)
    del params["encoder"]["norm_out"]["bias"]
    return params


def _bad_shape(params):
    params = jax.tree_util.tree_map(lambda a: a, params)
    params["post_quant_conv"]["kernel"] = np.zeros((1, 1, 3, 4), np.float32)
    return params


@pytest.mark.parametrize("corrupt, error", [(_drop, KeyError), (_bad_shape, ValueError)],
                         ids=["missing", "bad_shape"])
def test_converter_raises(corrupt, error):
    cfg = config(2)
    _, params, port = build_pair(cfg, 16)
    with pytest.raises(error):
        autoencoderkl_state_dict_from_jax(
            corrupt(params), port.state_dict(), cfg["num_channels"], cfg["num_res_blocks"],
            cfg["attention_levels"], False, False)


def test_converted_tensors_do_not_alias_the_params():
    cfg = config(2)
    _, params, port = build_pair(cfg, 16, seed=3)
    sd = autoencoderkl_state_dict_from_jax(
        params, port.state_dict(), cfg["num_channels"], 1, cfg["attention_levels"], False, False)
    before = params["encoder"]["norm_out"]["scale"].copy()
    sd[f"encoder.blocks.{len(port.encoder.blocks) - 2}.weight"].add_(1.0)
    np.testing.assert_array_equal(params["encoder"]["norm_out"]["scale"], before)


def test_sampling_is_mu_plus_sigma_times_the_generators_draw():
    port = AutoencoderKL(**config(2))
    g = torch.Generator().manual_seed(11)
    mu, sigma = torch.randn(2, 3, 4, 4, generator=g), torch.rand(2, 3, 4, 4, generator=g)
    z = port.sampling(mu, sigma, generator=torch.Generator().manual_seed(7))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(z, mu + eps * sigma, rtol=0, atol=0)
    z2 = port.encode_stage_2_inputs(torch.zeros(2, 1, 16, 16),
                                    generator=torch.Generator().manual_seed(7))
    assert z2.shape == (2, 3, 4, 4) and z2.dtype == torch.float32


def test_invalid_channels_raise():
    with pytest.raises(ValueError, match="multiple of norm_num_groups"):
        AutoencoderKL(**dict(config(2), num_channels=(8, 10, 16)))
    with pytest.raises(ValueError, match="same size"):
        AutoencoderKL(**dict(config(2), attention_levels=(False, True)))
