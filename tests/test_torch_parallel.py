"""The port's mesh steps and layers across real processes, held against the
JAX package (tests/test_parallel.py's checks).

Two spawns (tests/test_torch_distributed.py::spawn, each world with one
deadline):
- two ranks on {"data": 2}: the step against the JAX single-device step on
  the full batch (with the JAX draws given), with accumulation and the EMA;
  the step's own draws against the port's one-rank step on the full batch;
  the synced BatchNorm and the codebook all-reduce against JAX's global-batch
  statistics; the adversarial and VQ-GAN steps against the port's
  single-device steps on the full batch;
- four ranks on {"data": 2, "space": 2}: the spatially cut step, the cut
  2D UNet forward, the cut 3D UNet forward through the fused ResnetBlock
  (kernel 5's plain version), and the cut AutoencoderKL encode and decode,
  each against the unsharded JAX function; the guided latent sampler with
  its decode, cut against whole.

Tolerances:
- the data-parallel step: the loss within 1e-6 and the parameters' L1 norm
  within 1e-6 relative (the JAX tests' bounds), every parameter within
  atol 1e-6 + rtol 1e-4 (tests/test_torch_train.py's, for the two
  frameworks' convolution and attention sums); Adam runs with eps 1e-3 as
  there;
- the cut step: the same loss and L1 bounds at 1e-5: its GroupNorms take
  their statistics from sums over the slabs, and its gradients are summed
  over four ranks in a different order;
- the cut forwards: 1e-5 of the largest output (f32);
- the guided sampler, cut against whole: 1e-4 of the largest output. The
  cut GroupNorms sum their statistics over the slabs, the whole run's
  F.group_norm in one pass over the volume; their ~1e-7 apart grows
  through four guided steps (scale 3) and the decode to ~2e-5 of the
  largest value;
- the synced BatchNorm and the codebook: rtol 1e-5, atol 1e-6, as the JAX
  tests;
- the adversarial and VQ-GAN steps and the port's own draws: losses rtol
  1e-5, parameters atol 1e-6 + rtol 1e-4 (the same sums in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu.networks.nets import AutoencoderKL as JaxAEKL
from generativemodels_tpu.networks.nets import PatchDiscriminator as JaxPatch
from generativemodels_tpu.parallel import train as jtrain
from generativemodels_tpu_torch.networks import (
    autoencoderkl_state_dict_from_jax,
    patchgan_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import (
    AutoencoderKL,
    DiffusionModelUNet,
    PatchDiscriminator,
    VQVAE,
)
from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
from generativemodels_tpu_torch.parallel import (
    create_mesh,
    init_train_state,
    make_diffusion_train_step,
    partition_files,
)

from . import torch_dist_workers as workers
from .test_torch_autoencoderkl import random_params as aekl_random_params
from .test_torch_distributed import (
    EPS,
    LR,
    codebook_inputs,
    jax_codebook,
    jax_draws,
    jax_step,
    l1_norm,
    port_l1_norm,
    spawn,
    unet_pair,
)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

UNET = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=(8, 16), attention_levels=(False, True), norm_num_groups=8,
            num_head_channels=8)
UNET3D = dict(UNET, spatial_dims=3)
AEKL = dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=(8, 8), attention_levels=(False, False), latent_channels=3,
            norm_num_groups=8, with_encoder_nonlocal_attn=False,
            with_decoder_nonlocal_attn=False)
GUIDED = dict(spatial_dims=3, in_channels=3, out_channels=3, num_res_blocks=1,
              num_channels=(8, 8), attention_levels=(False, True), norm_num_groups=8,
              num_head_channels=8, with_conditioning=True, cross_attention_dim=4)
SHAPE = (4, 1, 16, 16)


def _np_state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _seeded(cls, seed: int, **cfg):
    torch.manual_seed(seed)
    return cls(**cfg)


def _assert_params(got: dict, want: dict, atol: float = 1e-6, rtol: float = 1e-4) -> None:
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=rtol, err_msg=name)


def _jax_params_as_port(state, port_cfg) -> dict:
    port = DiffusionModelUNet(**port_cfg)
    return {k: v.numpy() for k, v in
            unet_state_dict_from_jax(jax.device_get(state.params), port.state_dict()).items()}


# ------------------------------------------------------------ two ranks


def _adversarial_inputs() -> dict:
    g_cfg = dict(AEKL, spatial_dims=2)
    d_cfg = dict(spatial_dims=2, num_channels=8, in_channels=1, num_layers_d=2, norm="BATCH",
                 norm_axis_name="data")
    rs = np.random.RandomState(21)
    return dict(g_cfg=g_cfg, d_cfg=d_cfg,
                g_state=_np_state(_seeded(AutoencoderKL, 1, **g_cfg)),
                d_state=_np_state(_seeded(PatchDiscriminator, 2, **d_cfg)),
                x=rs.rand(4, 1, 32, 32).astype(np.float32),
                eps=rs.randn(4, 3, 16, 16).astype(np.float32))


def _vqgan_inputs() -> dict:
    vq_cfg = dict(spatial_dims=2, in_channels=1, out_channels=1, num_channels=(8, 8),
                  num_res_layers=1, num_res_channels=(8, 8), num_embeddings=16,
                  embedding_dim=4, downsample_parameters=((2, 4, 1, 1), (2, 4, 1, 1)),
                  upsample_parameters=((2, 4, 1, 1, 0), (2, 4, 1, 1, 0)))
    d_cfg = dict(spatial_dims=2, num_channels=8, in_channels=1, num_layers_d=2, norm="BATCH",
                 norm_axis_name="data")
    return dict(vq_cfg=vq_cfg, d_cfg=d_cfg,
                vq_state=_np_state(_seeded(VQVAE, 3, **vq_cfg)),
                d_state=_np_state(_seeded(PatchDiscriminator, 4, **d_cfg)),
                x=np.random.RandomState(22).rand(4, 1, 32, 32).astype(np.float32))


def _bn_pair():
    """A BATCH-norm PatchGAN (JAX and port weights) and a global batch whose
    two halves differ (tests/test_parallel.py::TestSyncBatchNorm)."""
    kw = dict(spatial_dims=2, num_channels=4, in_channels=1, num_layers_d=2, norm="BATCH")
    jmodel = JaxPatch(**kw)
    x = np.random.RandomState(0).randn(16, 1, 32, 32).astype(np.float32)
    x *= (1.0 + np.arange(16).reshape(-1, 1, 1, 1) / 4.0).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))
    port = PatchDiscriminator(**kw)
    state = patchgan_state_dict_from_jax(variables["params"], port.state_dict(),
                                         variables["batch_stats"])
    return jmodel, variables, kw, {k: v.numpy() for k, v in state.items()}, x


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    jmodel, params, state = unet_pair(UNET, SHAPE, seed=31)
    images = np.random.RandomState(32).uniform(-1, 1, SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(33)
    noise, timesteps = jax_draws(rng, jnp.asarray(images))
    cfg, cb_state, cb_x = codebook_inputs(12)
    bn_jmodel, bn_vars, bn_kw, bn_state, bn_x = _bn_pair()
    inputs = dict(cfg=UNET, state=state, lr=LR, eps=EPS, images=images, noise=noise,
                  timesteps=timesteps, seed=34,
                  bn=dict(cfg=bn_kw, state=bn_state, x=bn_x),
                  codebook=dict(cfg=cfg, state=cb_state, x=cb_x),
                  adversarial=_adversarial_inputs(), vqgan=_vqgan_inputs())
    outs = spawn("data_parallel", 2, inputs, tmp_path_factory.mktemp("data_parallel"))

    refs = {}
    for name, kw in (("dp", {}), ("acc", {"accumulate_steps": 2})):
        loss, jstate = jax_step(jmodel, params, images, rng, **kw)
        refs[name] = dict(loss=loss, norm=l1_norm(jstate.params),
                          params=_jax_params_as_port(jstate, UNET))
        if name == "dp":
            # the JAX step's EMA update after this step, from the initial params
            ema = jtrain._ema_update(jtrain.TrainState(None, None, jnp.asarray(0), params),
                                     jstate.params, 0.9)
            refs["ema"] = dict(refs["dp"], ema=_jax_params_as_port(
                jtrain.TrainState(ema, None, None), UNET))
    # the port's one-rank step on the full batch, drawing from the same seed
    model = DiffusionModelUNet(**UNET)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    st = init_train_state(model.train(), torch.optim.Adam(model.parameters(), lr=LR, eps=EPS))
    st, loss = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000))(
        st, torch.from_numpy(images), torch.Generator().manual_seed(34))
    refs["drawn"] = dict(loss=float(loss), params=_np_state(st.model))

    _, mutated = bn_jmodel.apply(bn_vars, jnp.asarray(bn_x), deterministic=False,
                                 mutable=["batch_stats"])
    refs["bn_out"] = np.asarray(bn_jmodel.apply(
        bn_vars, jnp.asarray(bn_x), deterministic=False, mutable=["batch_stats"])[0][-1])
    refs["bn_stats"] = mutated["batch_stats"]
    refs["codebook"] = jax_codebook(cfg, cb_state, cb_x)

    c = inputs["adversarial"]
    g, d = workers._adversarial_models(c)
    _, out = workers.adversarial_step(c, g, d, torch.from_numpy(c["x"]),
                                      torch.from_numpy(c["eps"]))
    refs["adversarial"] = dict(losses={str(k): float(v) for k, v in out.items() if v.ndim == 0},
                               g=_np_state(g), d=_np_state(d))
    c = inputs["vqgan"]
    vq, d = workers.vqgan_models(c)
    _, out = workers.vqgan_step(vq, d, torch.from_numpy(c["x"]))
    refs["vqgan"] = dict(losses={k: float(v) for k, v in out.items()}, g=_np_state(vq),
                         d=_np_state(d))
    return outs, refs


@pytest.mark.parametrize("variant", ["dp", "acc", "ema"])
def test_data_parallel_step_matches_jax_full_batch(data_parallel, variant):
    outs, refs = data_parallel
    ref = refs[variant]
    for o in outs:
        got = o[variant]
        assert abs(got["loss"] - ref["loss"]) < 1e-6
        assert abs(port_l1_norm(got["params"]) - ref["norm"]) / ref["norm"] < 1e-6
        _assert_params(got["params"], ref["params"])
        if variant == "ema":
            _assert_params({k: got["ema"][k] for k in ref["ema"]}, ref["ema"])
    # every rank ends with the same parameters
    for name, p in outs[0][variant]["params"].items():
        np.testing.assert_array_equal(p, outs[1][variant]["params"][name])


def test_data_parallel_draws_equal_the_one_rank_step(data_parallel):
    outs, refs = data_parallel
    for o in outs:
        np.testing.assert_allclose(o["drawn"]["loss"], refs["drawn"]["loss"], rtol=1e-5)
        _assert_params(o["drawn"]["params"], refs["drawn"]["params"])


def test_synced_batchnorm_matches_global_batch(data_parallel):
    outs, refs = data_parallel
    for rank, o in enumerate(outs):
        np.testing.assert_allclose(o["bn"]["out"], refs["bn_out"][rank * 8:(rank + 1) * 8],
                                   rtol=1e-5, atol=1e-6)
        for layer in range(2):
            stats = refs["bn_stats"][f"norm_{layer}"]["BatchNorm_0"]
            for key, name in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(o["bn"]["state"][f"{layer}.adn.N.{name}"],
                                           np.asarray(stats[key]), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{layer} {key}")


def test_ema_quantizer_all_reduce_matches_global_update(data_parallel):
    outs, refs = data_parallel
    for o in outs:
        for name, want in refs["codebook"].items():
            np.testing.assert_allclose(o["codebook"][name], want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("step", ["adversarial", "vqgan"])
def test_adversarial_steps_under_a_data_mesh(data_parallel, step):
    outs, refs = data_parallel
    ref = refs[step]
    for o in outs:
        got = o[step]
        assert got["losses"].keys() == ref["losses"].keys()
        for k, v in ref["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, err_msg=k)
        _assert_params(got["g"], ref["g"])
        _assert_params(got["d"], ref["d"])


# ------------------------------------------------------------ data x space


def _aekl_inputs() -> tuple:
    jmodel = JaxAEKL(**AEKL)
    x = np.random.RandomState(41).randn(2, 1, 16, 16, 16).astype(np.float32)
    struct = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)},
        jnp.asarray(x)))["params"]
    params = aekl_random_params(struct, 42)
    port = AutoencoderKL(**AEKL)
    state = autoencoderkl_state_dict_from_jax(
        params, port.state_dict(), AEKL["num_channels"], AEKL["num_res_blocks"],
        AEKL["attention_levels"], False, False)
    z = np.random.RandomState(43).randn(2, 3, 8, 8, 8).astype(np.float32)
    return jmodel, params, dict(cfg=AEKL, state={k: v.numpy() for k, v in state.items()},
                                x=x, z=z)


@pytest.fixture(scope="module")
def data_space(tmp_path_factory):
    jmodel, params, state = unet_pair(UNET, SHAPE, seed=51)
    images = np.random.RandomState(52).uniform(-1, 1, SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(53)
    noise, timesteps = jax_draws(rng, jnp.asarray(images))
    x = np.random.RandomState(54).randn(*SHAPE).astype(np.float32)
    t = np.array([3, 700, 40, 999], np.int64)
    j3d, p3d, s3d = unet_pair(UNET3D, (4, 1, 8, 8, 8), seed=55)
    x3d = np.random.RandomState(56).randn(4, 1, 8, 8, 8).astype(np.float32)
    jaekl, aparams, aekl = _aekl_inputs()
    _, _, gstate = unet_pair(GUIDED, (2, 3, 8, 8, 8), seed=57,
                             context=jnp.zeros((2, 2, 4)))
    guided = dict(cfg=GUIDED, state=gstate, aekl=aekl,
                  noise=np.random.RandomState(58).randn(2, 3, 8, 8, 8).astype(np.float32),
                  ctx=np.random.RandomState(59).randn(2, 2, 4).astype(np.float32))
    inputs = dict(cfg=UNET, state=state, lr=LR, eps=EPS, images=images, noise=noise,
                  timesteps=timesteps, x=x, t=t,
                  fused=dict(cfg=UNET3D, state=s3d, x=x3d, t=t), aekl=aekl, guided=guided)
    outs = spawn("data_space", 4, inputs, tmp_path_factory.mktemp("data_space"))

    loss, jstate = jax_step(jmodel, params, images, rng)
    jt = jnp.asarray(t, jnp.int32)
    refs = dict(
        step=dict(loss=loss, norm=l1_norm(jstate.params), params=_jax_params_as_port(jstate, UNET)),
        unet=np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), jt)),
        fused=np.asarray(j3d.apply({"params": p3d}, jnp.asarray(x3d), jt)),
        decode=np.asarray(jaekl.apply({"params": aparams}, jnp.asarray(aekl["z"]),
                                      method=JaxAEKL.decode)),
        encode=np.asarray(jaekl.apply({"params": aparams}, jnp.asarray(aekl["x"]),
                                      method=JaxAEKL.encode)[0]),
    )
    return outs, refs


def _piece(a: np.ndarray, coords: dict) -> np.ndarray:
    """Rank (data i, space j)'s rows and slab of axis 2 of a global array."""
    rows = np.array_split(a, 2)[coords["data"]]
    return np.array_split(rows, 2, axis=2)[coords["space"]]


def test_data_space_step_matches_jax_full_batch(data_space):
    outs, refs = data_space
    ref = refs["step"]
    for o in outs:
        assert abs(o["step"]["loss"] - ref["loss"]) < 1e-5
        assert abs(port_l1_norm(o["step"]["params"]) - ref["norm"]) / ref["norm"] < 1e-5
        _assert_params(o["step"]["params"], ref["params"])


@pytest.mark.parametrize("name", ["unet", "fused", "decode", "encode"])
def test_spatially_cut_forward_matches_jax(data_space, name):
    outs, refs = data_space
    want = refs[name]
    for o in outs:
        got, piece = o[name], _piece(want, o["coords"])
        assert got.shape == piece.shape
        np.testing.assert_allclose(got, piece, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_spatially_cut_guided_latent_sampler(data_space, sampler):
    """The guided latent sampler and the decode on a cut latent are the
    whole-volume ones (tests/test_parallel.py::test_end_to_end_sharded_ldm_pipeline)."""
    outs, _ = data_space
    for o in outs:
        whole, cut = o["guided"][sampler]["whole"], o["guided"][sampler]["cut"]
        assert np.isfinite(cut).all()
        np.testing.assert_allclose(cut, _piece(whole, o["coords"]), rtol=0,
                                   atol=1e-4 * float(np.abs(whole).max()))


# ------------------------------------------------------------ one process


def test_partition_files_disjoint_covering_equal():
    paths = [f"f{i:02d}" for i in range(10)]
    parts = [partition_files(paths, i, 3) for i in range(3)]
    assert all(len(p) == 3 for p in parts)
    assert sorted(p for part in parts for p in part) == sorted(paths[:9])
    assert partition_files(["a", "b", "c"], 0, 1) == ["a", "b", "c"]
    with pytest.raises(ValueError, match="cannot be partitioned"):
        partition_files(["only"], 0, 2)
    with pytest.raises(ValueError, match="out of range"):
        partition_files(["a", "b"], 2, 2)


def test_file_dataset_explicit_partition(tmp_path):
    from generativemodels_tpu_torch.data import file_dataset

    for i in range(6):
        np.save(tmp_path / f"s{i}.npy", np.full((2, 2), float(i), np.float32))
    shards = [[int(a[0, 0]) for a in file_dataset(str(tmp_path), loop=False, shuffle=True,
                                                   seed=3, process_index=r, process_count=2)]
              for r in range(2)]
    assert len(shards[0]) == len(shards[1]) == 3
    assert sorted(shards[0] + shards[1]) == [0, 1, 2, 3, 4, 5]


def test_paired_stream_explicit_partition(tmp_path):
    from generativemodels_tpu_torch.data import paired_stream

    img_dir, lab_dir = tmp_path / "img", tmp_path / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    for i in range(6):
        np.save(img_dir / f"s{i}.npy", np.full((4, 4), float(i), np.float32))
        np.save(lab_dir / f"s{i}.npy", np.full((4, 4), float(10 + i), np.float32))
    shards = []
    for r in range(2):
        pairs = list(paired_stream(str(img_dir), str(lab_dir), (4, 4), fit="none", seed=5,
                                   loop=False, process_index=r, process_count=2))
        shards.append([(int(np.ravel(a)[0]), int(np.ravel(b)[0])) for a, b in pairs])
    assert len(shards[0]) == len(shards[1]) == 3
    assert sorted(shards[0] + shards[1]) == [(i, 10 + i) for i in range(6)]


def test_mesh_shape_must_fit_the_world():
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        create_mesh({"data": 2, "space": 4}, device="cpu")
    mesh = create_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.group("data") is None


def test_mesh_step_arguments_are_checked():
    sched = DDPMScheduler()
    with pytest.raises(ValueError, match="needs a mesh"):
        make_diffusion_train_step(sched, spatial_shard_axis=2)
    with pytest.raises(ValueError, match="no axis 'space'"):
        make_diffusion_train_step(sched, mesh=create_mesh(device="cpu"), spatial_shard_axis=2)


def test_initialize_multihost_resolution(monkeypatch):
    """No coordinator anywhere: a single process, with the JAX function's
    warning; a coordinator without the process count and rank raises."""
    from generativemodels_tpu_torch.parallel import initialize_multihost

    for key in ("GMTPU_COORD", "GMTPU_NPROC", "GMTPU_RANK", "MASTER_ADDR", "MASTER_PORT",
                "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.warns(UserWarning, match="SINGLE process"):
        assert initialize_multihost(device="cpu") == (0, 1)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(ValueError, match="without the process count"):
        initialize_multihost(device="cpu")


def test_sharding_pieces_of_a_global_tensor():
    """A world of one holds every piece; the spec names the cut axes."""
    from generativemodels_tpu_torch.parallel import batch_sharding, replicated, spatial_sharding

    mesh = create_mesh({"data": 1, "space": 1}, device="cpu")
    x = torch.arange(2 * 3 * 4 * 4.0).reshape(2, 3, 4, 4)
    assert batch_sharding(mesh, 4).spec == ("data", None, None, None)
    assert spatial_sharding(mesh, 4).spec == ("data", None, "space", None)
    assert replicated(mesh).spec == ()
    for sharding in (batch_sharding(mesh, 4), spatial_sharding(mesh, 4), replicated(mesh)):
        assert torch.equal(sharding.shard(x), x)


def test_multihost_batches_check_the_batch(tmp_path):
    """A global batch that the "data" ranks do not divide raises here (the
    JAX function checks only the process count, pipeline.py:298); a "space"
    axis leaves each rank the whole rows of its data group."""
    from generativemodels_tpu_torch.data import multihost_device_batches

    mesh = create_mesh({"data": 1}, device="cpu")
    for i in range(4):
        np.save(tmp_path / f"x{i}.npy", np.zeros((4, 4), np.float32))
    batches = multihost_device_batches(str(tmp_path), (4, 4), 2, mesh)
    assert tuple(next(batches).shape) == (2, 1, 4, 4)
    batches.close()
    cut = create_mesh({"data": 1, "space": 1}, device="cpu")
    cut.size, cut.shape = 2, {"data": 1, "space": 2}  # a stand-in for a cut mesh of two ranks
    batches = multihost_device_batches(str(tmp_path), (4, 4), 2, cut)
    assert tuple(next(batches).shape) == (2, 1, 4, 4)
    batches.close()
    two = create_mesh({"data": 1}, device="cpu")
    two.size, two.shape = 2, {"data": 2}  # a stand-in for a data axis of two ranks
    with pytest.raises(ValueError, match="across 2 data ranks"):
        multihost_device_batches(str(tmp_path), (4, 4), 3, two)


def test_recipe_batch_must_divide_over_the_processes(monkeypatch):
    """--batch not divisible by the process count raises (the JAX recipes
    floor it, train_2d_ddpm.py:145)."""
    import argparse

    from generativemodels_tpu_torch.recipes import data_flags

    monkeypatch.setattr("generativemodels_tpu_torch.parallel.initialize_multihost",
                        lambda device=None: (0, 2))
    args = argparse.Namespace(data_parallel=True, multihost=False, batch=3, device="cpu")
    with pytest.raises(ValueError, match="does not divide over 2 processes"):
        data_flags.launch(args)


def test_adversarial_steps_refuse_a_spatial_cut():
    """The adversarial steps refuse a spatial cut they cannot serve: a
    "space" axis of more than one rank that the step does not cut, a cut of
    an axis other than 2 (ROADMAP C's difference from the JAX package), and
    a VQ-GAN step under a mesh whose codebook does not sync over "data"."""
    from generativemodels_tpu_torch.engines import trainer
    from generativemodels_tpu_torch.recipes import train_vqgan

    cut = create_mesh({"data": 1, "space": 1}, device="cpu")
    cut.shape = {"data": 1, "space": 2}  # a stand-in for a cut mesh of two ranks
    fns = [lambda *a: None] * 5
    with pytest.raises(ValueError, match="needs spatial_shard_axis=2"):
        trainer.make_adversarial_train_step(*fns, mesh=cut)
    with pytest.raises(ValueError, match="needs spatial_shard_axis=2"):
        train_vqgan.make_vqgan_step(mesh=cut)
    for axis in (3, 4):
        with pytest.raises(ValueError, match="takes axis 2"):
            trainer.make_adversarial_train_step(*fns, mesh=cut, spatial_shard_axis=axis)
        with pytest.raises(ValueError, match="takes axis 2"):
            train_vqgan.make_vqgan_step(mesh=cut, spatial_shard_axis=axis)
    assert trainer.make_adversarial_train_step(*fns, mesh=cut, spatial_shard_axis=2).mesh is cut
    c = _vqgan_inputs()
    vq = VQVAE(**c["vq_cfg"])  # axis_name None: its codebook stays local
    state = train_vqgan.VQGANState(vq, None, PatchDiscriminator(**c["d_cfg"]), None, 0)
    with pytest.raises(ValueError, match="syncs over 'data'"):
        train_vqgan.make_vqgan_step(mesh=create_mesh(device="cpu"))(state, None)
