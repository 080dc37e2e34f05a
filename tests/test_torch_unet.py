"""The port's DiffusionModelUNet against the JAX one, with carried-over weights.

A tiny UNet ((32, 64, 64), attention on levels 1 and 2, 32 head channels,
8 groups, 16x16 input, B=2), plus a resblock_updown variant and a 3D one
(8^3 input). Every JAX parameter is drawn from a numpy seed
(none is zero, the zero-initialised convs included), carried to the port
by `unet_state_dict_from_jax`, and both forwards see the same numpy input.
Outputs compare at atol = rtol = 1e-4 (f32; GroupNorm statistics and conv
sums are reduced in another order by the two frameworks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import DiffusionModelUNet as JaxUNet
from generativemodels_tpu_torch.networks import unet_state_dict_from_jax
from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
    num_channels=(32, 64, 64), attention_levels=(False, True, True),
    num_head_channels=32, norm_num_groups=8,
)
SPATIAL = (16, 16)
BATCH = 2


def random_params(struct, seed: int) -> dict:
    """Every leaf of a flax params tree drawn from a numpy seed: kernels at
    1/sqrt(fan_in), GroupNorm scales around 1, biases and embeddings small."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        r = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            r = r / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            r = 1.0 + 0.1 * r
        else:
            r = 0.1 * r
        return r.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, struct)


def spatial_shape(cfg) -> tuple[int, ...]:
    return SPATIAL if cfg["spatial_dims"] == 2 else (8,) * cfg["spatial_dims"]


def build_pair(seed: int = 0, **overrides):
    """(jax model, numpy params, port model with the same weights)."""
    cfg = dict(TINY, **overrides)
    jmodel = JaxUNet(**cfg)
    args = [jnp.zeros((BATCH, 1, *spatial_shape(cfg))), jnp.zeros((BATCH,), jnp.int32)]
    kwargs = {}
    if cfg.get("num_class_embeds"):
        kwargs["class_labels"] = jnp.zeros((BATCH,), jnp.int32)
    struct = zoo_convert.params_structure(jmodel, *args, **kwargs)
    params = random_params(struct, seed)
    port = DiffusionModelUNet(**cfg)
    port.load_state_dict(unet_state_dict_from_jax(params, port.state_dict()), strict=True)
    return jmodel, params, port.eval()


def inputs(seed: int = 1, spatial=SPATIAL):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((BATCH, 1, *spatial)).astype(np.float32)
    t = np.array([3, 700], dtype=np.int64)
    return x, t


@pytest.mark.parametrize(
    "overrides",
    [
        dict(use_flash_attention=True),
        dict(use_flash_attention=False),
        dict(use_flash_attention=False, resblock_updown=True),
        dict(use_flash_attention=True, spatial_dims=3, num_channels=(16, 32, 32),
             num_head_channels=16),
    ],
    ids=["flash", "plain", "resblock_updown", "3d_flash"],
)
def test_forward_matches_jax(overrides):
    """use_flash_attention=True: JAX runs its Pallas kernel in interpret mode,
    the port its plain version (the CPU path of the CUDA kernel)."""
    jmodel, params, port = build_pair(**overrides)
    spatial = spatial_shape(dict(TINY, **overrides))
    x, t = inputs(spatial=spatial)
    j_out = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t, dtype=jnp.int32))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t))
    assert out.dtype == torch.float32 and out.shape == (BATCH, 1, *spatial)
    assert float(np.abs(np.asarray(j_out)).max()) > 0.1  # the check is not empty
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


def test_forward_with_class_embedding_and_controlnet_residuals():
    jmodel, params, port = build_pair(seed=4, num_class_embeds=3, use_flash_attention=False)
    x, t = inputs(5)
    labels = np.array([2, 0])
    rng = np.random.RandomState(6)
    # one residual per down-path sample: conv_in, then each level's
    # resnets and downsampler; at 16x16 with three levels
    shapes = [(32, 16), (32, 16), (32, 8), (64, 8), (64, 4), (64, 4)]
    down = [rng.standard_normal((BATCH, c, s, s)).astype(np.float32) for c, s in shapes]
    mid = rng.standard_normal((BATCH, 64, 4, 4)).astype(np.float32)
    j_out = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, dtype=jnp.int32),
        class_labels=jnp.asarray(labels),
        down_block_additional_residuals=[jnp.asarray(r) for r in down],
        mid_block_additional_residual=jnp.asarray(mid),
    )
    with torch.no_grad():
        out = port(
            torch.from_numpy(x), torch.from_numpy(t), class_labels=torch.from_numpy(labels),
            down_block_additional_residuals=[torch.from_numpy(r) for r in down],
            mid_block_additional_residual=torch.from_numpy(mid),
        )
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)


def test_state_dict_round_trips_through_zoo_convert():
    """port.state_dict() -> the JAX package's own torch-checkpoint converter
    gives back exactly the JAX params the port was loaded from."""
    jmodel, params, port = build_pair(seed=2)
    struct = zoo_convert.params_structure(
        jmodel, jnp.zeros((BATCH, 1, *SPATIAL)), jnp.zeros((BATCH,), jnp.int32)
    )
    back = zoo_convert.convert_diffusion_model_unet(port.state_dict(), struct)
    flat_in = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf)


def test_converted_tensors_do_not_alias_the_params():
    jmodel, params, port = build_pair(seed=3)
    sd = unet_state_dict_from_jax(params, port.state_dict())
    before = params["conv_in"]["bias"].copy()
    sd["conv_in.conv.bias"].add_(1.0)
    np.testing.assert_array_equal(params["conv_in"]["bias"], before)


def _drop(params):
    params = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    del params["conv_in"]["bias"]
    return params


def _extra(params):
    return dict(params, extra_layer={"kernel": np.zeros((3, 3), np.float32)})


def _bad_shape(params):
    params = {k: dict(v) if isinstance(v, dict) else v for k, v in params.items()}
    params["conv_in"]["kernel"] = np.zeros((3, 3, 1, 16), np.float32)
    return params


@pytest.mark.parametrize(
    "corrupt, error",
    [(_drop, KeyError), (_extra, KeyError), (_bad_shape, ValueError)],
    ids=["missing", "leftover", "bad_shape"],
)
def test_converter_raises(corrupt, error):
    _, params, port = build_pair(seed=3)
    with pytest.raises(error):
        unet_state_dict_from_jax(corrupt(params), port.state_dict())


def test_load_reference_checkpoint_wrapped_and_prefixed(tmp_path):
    """A reference checkpoint ({"state_dict": ...} with DataParallel's
    `module.` prefix) loads strictly into a port UNet, from a file or in
    memory, and the JAX `load_reference_checkpoint` of the same state dict
    gives the same forward within 1e-5 (relative)."""
    from generativemodels_tpu_torch.networks import load_reference_checkpoint

    jmodel, _, source = build_pair(seed=3)
    wrapped = {"state_dict": {f"module.{k}": v.clone() for k, v in source.state_dict().items()},
               "epoch": 7}
    path = tmp_path / "model.pt"
    torch.save(wrapped, path)
    port = DiffusionModelUNet(**TINY)
    assert load_reference_checkpoint(str(path), port) is port
    for k, v in source.state_dict().items():
        torch.testing.assert_close(port.state_dict()[k], v, rtol=0, atol=0)
    from_memory = load_reference_checkpoint(wrapped, DiffusionModelUNet(**TINY))
    for k, v in source.state_dict().items():
        torch.testing.assert_close(from_memory.state_dict()[k], v, rtol=0, atol=0)

    missing = dict(wrapped["state_dict"])
    missing.pop(next(iter(missing)))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(missing, DiffusionModelUNet(**TINY))
    extra = dict(wrapped["state_dict"], **{"module.extra.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_checkpoint(extra, DiffusionModelUNet(**TINY))

    variables = zoo_convert.load_reference_checkpoint(str(path), jmodel)
    x, t = inputs()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
