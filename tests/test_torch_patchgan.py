"""The port's PatchDiscriminator and MultiScalePatchDiscriminator against the
JAX modules.

Every JAX parameter (and BatchNorm statistic) is drawn from a numpy seed and
carried to the port by `patchgan_state_dict_from_jax`. Tolerances: every
returned feature map within 1e-5 of its largest value, in eval mode (the JAX
module's `deterministic=True`) and in training mode; the BatchNorm running
statistics after one training call at rtol 1e-5 (atol 1e-7 for means near 0).
Inputs keep at least 9 values a channel under every BatchNorm in training
mode: both packages take flax's E[x^2] - E[x]^2 variance, which over the 2
values of a 1x1 map at batch 2 turns f32 rounding into 1e-4 of the output.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import MultiScalePatchDiscriminator as JaxMulti
from generativemodels_tpu.networks.nets import PatchDiscriminator as JaxPatch
from generativemodels_tpu_torch.networks import patchgan_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets import (
    MultiScalePatchDiscriminator,
    PatchDiscriminator,
)
from tests.test_torch_unet import random_params

RTOL = 1e-5
BATCH = 2
NORMS = {"batch": "BATCH", "instance": "INSTANCE", "group": ("GROUP", {"num_groups": 4})}


def random_stats(struct, seed: int):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        return (0.1 * r if path[-1].key == "mean" else rng.uniform(0.5, 2.0, leaf.shape)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, struct)


def build_pair(jmodel, port, x: np.ndarray, seed: int):
    """(params, batch_stats or None), the port loaded with them."""
    variables = zoo_convert.variables_structure(jmodel, jnp.asarray(x))
    params = random_params(variables["params"], seed)
    stats = random_stats(variables["batch_stats"], seed + 1) if "batch_stats" in variables \
        else None
    port.load_state_dict(patchgan_state_dict_from_jax(params, port.state_dict(), stats),
                         strict=True)
    return params, stats


def assert_close(got: torch.Tensor, want) -> None:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    assert float(np.abs(got - want).max()) <= RTOL * scale


def run_jax(jmodel, params, stats, x, train: bool):
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    return jmodel.apply(variables, jnp.asarray(x), deterministic=not train,
                        mutable=["batch_stats"] if train and stats is not None else False)


@pytest.mark.parametrize("norm", list(NORMS))
@pytest.mark.parametrize("spatial_dims", [2, 3], ids=["2d", "3d"])
def test_patch_discriminator_matches_jax(spatial_dims, norm):
    size = 32 if spatial_dims == 2 else 16
    kw = dict(spatial_dims=spatial_dims, num_channels=8, in_channels=1, num_layers_d=2,
              norm=NORMS[norm])
    jmodel, port = JaxPatch(**kw), PatchDiscriminator(**kw)
    x = np.random.RandomState(1).standard_normal((BATCH, 1) + (size,) * spatial_dims
                                                 ).astype(np.float32)
    params, stats = build_pair(jmodel, port, x, seed=2)
    for train in (False, True):
        port.train(train)
        got = port(torch.from_numpy(x))
        out = run_jax(jmodel, params, stats, x, train)
        want, mutated = out if train and stats is not None else (out, None)
        assert len(got) == len(want) == 4
        assert got[-1].dtype == torch.float32
        for g, w in zip(got, want):
            assert_close(g, w)
        if mutated is not None:
            for l in range(2):
                bn = getattr(port, str(l)).adn.N
                for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
                    np.testing.assert_allclose(
                        buf.numpy(), np.asarray(mutated["batch_stats"][f"norm_{l}"]
                                                ["BatchNorm_0"][name]),
                        rtol=RTOL, atol=1e-7, err_msg=f"norm_{l} {name}")


@pytest.mark.parametrize("pooling", [None, "avg"], ids=["deeper", "pooled"])
def test_multiscale_discriminator_matches_jax(pooling):
    kw = dict(num_d=2, num_layers_d=2, spatial_dims=2, num_channels=8, in_channels=1,
              pooling_method=pooling, minimum_size_im=64, norm="BATCH")
    jmodel, port = JaxMulti(**kw), MultiScalePatchDiscriminator(**kw)
    x = np.random.RandomState(3).standard_normal((BATCH, 1, 64, 64)).astype(np.float32)
    params, stats = build_pair(jmodel, port, x, seed=4)
    for train in (False, True):
        port.train(train)
        outputs, features = port(torch.from_numpy(x))
        out = run_jax(jmodel, params, stats, x, train)
        (j_outputs, j_features) = out[0] if train else out
        for g, w in zip(outputs, j_outputs, strict=True):
            assert_close(g, w)
        for gs, ws in zip(features, j_features, strict=True):
            for g, w in zip(gs, ws, strict=True):
                assert_close(g, w)


@pytest.mark.parametrize("norm, message", [
    (("BATCH", {"momentum": 0.5}), "momentum"),
    (("INSTANCE", {"affine": True}), "affine"),
    (("GROUP", {"num_groups": 4, "affine": False}), "affine"),
    ("LAYER", "Unsupported norm"),
])
def test_unknown_norm_kwargs_raise(norm, message):
    """The JAX module drops these without a word; the port refuses them."""
    with pytest.raises(ValueError, match=message):
        PatchDiscriminator(spatial_dims=2, num_channels=8, in_channels=1, norm=norm)


def test_batchnorm_scale_init_and_momentum():
    """The JAX initialisation (scale from N(0, 0.02), conv weights from
    N(0, 0.02)) and flax's momentum 0.9 as torch's 0.1."""
    torch.manual_seed(0)
    port = PatchDiscriminator(spatial_dims=2, num_channels=64, in_channels=1, num_layers_d=2)
    bn = port._modules["1"].adn.N
    assert bn.momentum == pytest.approx(0.1)
    weight = bn.weight.detach()
    assert abs(float(weight.mean())) < 0.01 and 0.01 < float(weight.std()) < 0.03
    assert 0.015 < float(port.initial_conv.conv.weight.detach().std()) < 0.025
