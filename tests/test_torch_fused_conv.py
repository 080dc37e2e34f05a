"""Kernel 5's neighbourhood against the JAX package: the GroupNorm fold, the
plain version of the fused GroupNorm-SiLU-conv3d, its gradients, the fused
ResnetBlock route and a tiny fused 3D UNet.

The JAX side runs its Pallas kernel in interpret mode, as tests/test_ops.py
runs it on the CPU; the port runs the kernel's plain version (the CPU path
of the CUDA kernel, which tests/test_torch_kernels_gpu.py and chip_smoke.py
hold against it on the card). Tolerances:
- the fold and f32 convolutions: atol = rtol = 1e-5 (summation order of
  the moments and of 27 * Cin products);
- bf16 against the interpret kernel: one bf16 ulp of the output (rtol
  2**-7), both accumulate exact bf16 products in f32 and round once;
- gradients: rtol = atol = 1e-4 (f32 sums over the volume);
- the fused ResnetBlock and UNet in f32: atol = rtol = 1e-4, as the unfused
  UNet in test_torch_unet.py; the fused ResnetBlock in bf16: 3e-2 of the
  largest output, as test_torch_train.py's bf16 forward (both round to bf16
  at other places: flax rounds each elementwise op).
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks.nets.diffusion_model_unet import ResnetBlock as JaxResnetBlock
from generativemodels_tpu.ops import fused_conv as jfused
from generativemodels_tpu_torch.networks import unet_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets.diffusion_model_unet import ResnetBlock
from generativemodels_tpu_torch.ops import (
    fold_groupnorm_affine,
    fused_norm_silu_conv3d,
    fused_norm_silu_conv3d_reference,
)
from generativemodels_tpu_torch.ops.fused_conv import CONV_BN, CONV_RUNS, conv_tiles

from .test_torch_unet import BATCH, build_pair, inputs, random_params
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
NET_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 3e-2
# two levels keep the JAX side's interpret-mode kernel calls to 16 a forward
FUSED_3D = dict(spatial_dims=3, num_channels=(16, 32), attention_levels=(False, True),
                num_head_channels=16, use_flash_attention=False)


def _setup(cin=16, cout=24, g=4, d=5, h=6, w=7, seed=0):
    """x, w, gamma, beta, bias, residual, temb as numpy (ragged spatial dims)."""
    rng = np.random.RandomState(seed)

    def mk(*s, mul=1.0):
        return (mul * rng.standard_normal(s)).astype(np.float32)

    return (mk(2, d, h, w, cin, mul=2.0) + 0.5, mk(3, 3, 3, cin, cout, mul=0.1),
            1.0 + mk(cin, mul=0.1), mk(cin, mul=0.1), mk(cout), mk(2, d, h, w, cout),
            mk(2, cin))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("with_temb", [False, True])
def test_fold_groupnorm_affine_matches_jax(with_temb):
    x, _, gamma, beta, _, _, temb = _setup()
    temb = temb if with_temb else None
    j = jfused.fold_groupnorm_affine(*_j(x, gamma, beta), 4, 1e-6,
                                     temb=None if temb is None else jnp.asarray(temb))
    t = fold_groupnorm_affine(*_t(x, gamma, beta), 4, 1e-6,
                              temb=None if temb is None else torch.from_numpy(temb))
    for a, b in zip(t, j):
        assert a.dtype == torch.float32 and a.shape == (2, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_fold_reads_a_permuted_channels_first_view():
    x, _, gamma, beta, _, _, _ = _setup()
    xt = torch.from_numpy(x)
    view = xt.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    for a, b in zip(fold_groupnorm_affine(view, *_t(gamma, beta), 4),
                    fold_groupnorm_affine(xt, *_t(gamma, beta), 4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("apply_act", [True, False])
def test_reference_matches_jax_f32(residual, apply_act):
    x, w, gamma, beta, bias, res, _ = _setup()
    scale, shift = (np.asarray(a) for a in jfused.fold_groupnorm_affine(*_j(x, gamma, beta), 4))
    r = res if residual else None
    kernel = jfused.fused_norm_silu_conv3d(
        *_j(x, w, scale, shift, bias), residual=None if r is None else jnp.asarray(r),
        apply_act=apply_act, interpret=True,
    )
    xla = jfused._xla_equivalent(*_j(x, w, scale, shift, bias),
                                 None if r is None else jnp.asarray(r), apply_act)
    got = fused_norm_silu_conv3d(*_t(x, w, scale, shift, bias),
                                 residual=None if r is None else torch.from_numpy(r),
                                 apply_act=apply_act)
    assert got.shape == (2, 5, 6, 7, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)


def test_reference_matches_jax_kernel_bf16():
    x, w, gamma, beta, bias, res, _ = _setup(seed=1)
    scale, shift = (np.asarray(a) for a in jfused.fold_groupnorm_affine(*_j(x, gamma, beta), 4))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    rb = jnp.asarray(res).astype(jnp.bfloat16)
    kernel = jfused.fused_norm_silu_conv3d(xb, *_j(w, scale, shift, bias), residual=rb,
                                           interpret=True)
    got = fused_norm_silu_conv3d(
        torch.from_numpy(x).bfloat16(), *_t(w, scale, shift, bias),
        residual=torch.from_numpy(res).bfloat16(),
    )
    assert got.dtype == torch.bfloat16
    want = np.asarray(kernel.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=1e-6)


def test_gradients_match_jax_grad():
    """The autograd Function's backward (autograd of the plain version)
    against jax.grad through the JAX custom VJP, as test_custom_vjp_matches_xla_grad."""
    x, w, gamma, beta, bias, res, _ = _setup(cin=8, cout=8, g=2, seed=2)

    def jloss(x, w, bias, res):
        s, t = jfused.fold_groupnorm_affine(x, jnp.asarray(gamma), jnp.asarray(beta), 2)
        out = jfused.fused_norm_silu_conv3d(x, w, s, t, bias=bias, residual=res, interpret=True)
        return jnp.sum(out**2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*_j(x, w, bias, res))
    xt, wt, bt, rt = (a.requires_grad_() for a in _t(x, w, bias, res))
    s, t = fold_groupnorm_affine(xt, *_t(gamma, beta), 2)
    (fused_norm_silu_conv3d(xt, wt, s, t, bias=bt, residual=rt) ** 2).sum().backward()
    for got, ref in zip((xt.grad, wt.grad, bt.grad, rt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def test_bad_kernel_shapes_raise():
    x, w, gamma, beta, bias, _, _ = _setup()
    xt, scale, shift = torch.from_numpy(x), torch.ones(2, 16), torch.zeros(2, 16)
    with pytest.raises(ValueError, match="kernel"):
        fused_norm_silu_conv3d(xt, torch.zeros(3, 3, 1, 16, 8), scale, shift)
    with pytest.raises(ValueError, match="kernel"):
        fused_norm_silu_conv3d(xt, torch.zeros(3, 3, 3, 8, 8), scale, shift)


def test_plain_version_takes_the_channels_first_view():
    x, w, gamma, beta, bias, res, _ = _setup(seed=3)
    xt, rt = _t(x, res)
    scale, shift = fold_groupnorm_affine(xt, *_t(gamma, beta), 4)
    want = fused_norm_silu_conv3d_reference(xt, *_t(w), scale, shift, *_t(bias), rt)
    view = xt.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    got = fused_norm_silu_conv3d_reference(view, *_t(w), scale, shift, *_t(bias), rt)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_resnet_block_matches_jax(monkeypatch, dtype):
    """GMTPU_FUSED_RESBLOCK=1 on both sides; in != out channels (1x1 skip)."""
    monkeypatch.setenv("GMTPU_FUSED_RESBLOCK", "1")
    jblock = JaxResnetBlock(spatial_dims=3, in_channels=8, out_channels=16, temb_channels=32,
                            norm_num_groups=4, dtype=getattr(jnp, dtype))
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 6, 5, 7, 8)).astype(np.float32)  # channels-last for JAX
    emb = rng.standard_normal((2, 32)).astype(np.float32)
    struct = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb))
    params = random_params(struct["params"], 5)
    want = np.asarray(
        jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb)).astype(jnp.float32)
    )

    block = ResnetBlock(3, 8, 32, 16, norm_num_groups=4, dtype=getattr(torch, dtype))
    prefix = "down_blocks.0.resnets.0."
    wrapped = {"down_0": {"resnet_0": params}}
    template = {prefix + k: v for k, v in block.state_dict().items()}
    state = unet_state_dict_from_jax(wrapped, template)
    block.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(emb))
    got = got.permute(0, 2, 3, 4, 1).float().numpy()
    assert float(np.abs(want).max()) > 0.1
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **NET_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_fused_unet_3d_matches_jax(monkeypatch):
    monkeypatch.setenv("GMTPU_FUSED_RESBLOCK", "1")
    jmodel, params, port = build_pair(seed=6, **FUSED_3D)
    x, t = inputs(7, spatial=(8, 8, 8))
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, dtype=jnp.int32))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t))
    assert got.shape == (BATCH, 1, 8, 8, 8) and got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
    # the route was taken: the unfused route of the same weights differs in rounding only
    monkeypatch.setenv("GMTPU_FUSED_RESBLOCK", "0")
    with torch.no_grad():
        unfused = port(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(unfused.numpy(), got.numpy(), **NET_TOL)


REPO = Path(__file__).resolve().parent.parent
# chip_smoke.py's bf16 cases of kernel 5: every call shape of the 3D UNet's
# forward at 128^3
BF16_CASES = ("128_32to32", "128_32to32r", "128_96to32", "128_64to32", "64_32to64",
              "64_64to64r", "64_192to64", "64_96to64", "32_64to128", "32_128to128r",
              "32_128to128", "32_256to128", "32_192to128")
# (BN, R) at each level (the volume's edge) on the H100's 132 SMs
LEVEL_TILES = {128: (32, 4), 64: (32, 4), 32: (32, 2)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", BF16_CASES)
def test_conv_tiles_fill_the_card(name):
    """The tile, depth run and grid handed to the bf16 kernel at each case:
    the grid fills at least two waves of 132 SMs, or R is 1; no longer run
    of the kernel's list would still fill them."""
    cases = {case[0]: case for case in _chip_smoke().FUSED_CASES}
    _, (b, d, h, w), _, cout, _, dtype = cases[name]
    assert dtype == "bfloat16"
    bn, rd, grid = conv_tiles(b, d, h, w, cout)
    assert bn == CONV_BN and rd in CONV_RUNS and cout <= bn * grid[2] < cout + bn
    spatial = math.ceil(h / 4) * math.ceil(w / 32)
    assert grid == (spatial, b * math.ceil(d / rd), math.ceil(cout / bn))
    assert math.prod(grid) >= 2 * 132 or rd == 1
    for longer in (r for r in CONV_RUNS if r > rd):
        assert spatial * b * math.ceil(d / longer) * grid[2] < 2 * 132
    assert (bn, rd) == LEVEL_TILES[d]


def test_conv_tiles_follow_the_card_and_the_volume():
    """With fewer SMs a longer run fills the card; ragged volumes round up."""
    assert conv_tiles(1, 32, 32, 32, 128, sms=4) == (32, 4, (8, 8, 4))
    assert conv_tiles(1, 32, 32, 32, 128) == (32, 2, (8, 16, 4))
    assert conv_tiles(2, 5, 7, 9, 24) == (32, 1, (2, 10, 1))
    assert conv_tiles(3, 37, 130, 70, 130, sms=8) == (32, 4, (99, 30, 5))


def test_forward_launch_weights_cover_the_bf16_cases():
    """chip_smoke's per-case launches of one 3D forward: the 13 bf16 cases,
    22 launches, as phase 5 counts them on the model."""
    weights = _chip_smoke().FUSED_FORWARD_LAUNCHES
    assert tuple(weights) == BF16_CASES and sum(weights.values()) == 22
