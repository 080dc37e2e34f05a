"""The adversarial layers and steps under a spatial cut, across real
processes, held against the uncut port modules and the JAX steps.

One spawn (tests/test_torch_distributed.py::spawn) of two gloo ranks on a
{"data": 1, "space": 2} mesh (tests/torch_dist_workers.py::space_cut)
serves every check:
- the layers, each cut against the uncut port module on the same rank:
  the halo transposed convolution (the VQ-VAE's upsampling, the AEKL's
  `use_convtranspose` one in 3D, and two whose output is not twice the
  input), the PatchGAN (2D with instance, batch and group norm, 3D with
  instance norm) and the multi-scale one with its pooling, forward and
  backward, whose outputs do not split evenly (the ranks' pieces must
  tile the uncut output), the instance norm of pieces of unequal depth
  and of a 1x1 map (one rank holds it, the other nothing), the AEKL's
  GroupNorm of pieces of unequal depth, BatchNorm and
  its running statistics, `cut_mean` over pieces of unequal depth, and a
  3D UNet through the fused ResnetBlock route (kernel 5's halo slabs)
  forward and backward;
- the 3D LDM recipe's stage-1 step (2D, tiny: an AEKL with an attention
  level, a PatchGAN with BatchNorm synced over "data") and the VQ-GAN step
  (its EMA codebook over "data" and "space"), cut, against the JAX steps
  (`engines/trainer.py:41`, `recipes/train_vqgan.py:44`) on one CPU device
  with the whole batch and the same weights; the stage-1 step's latent
  draw is the port's global draw (`parallel.mesh.draw_local`), handed to
  the JAX step as its input;
- `multihost_device_batches` on the cut mesh: the two ranks hold the same
  rows, in the order one process reads them.

Tolerances:
- the layers: each output, the input's gradient and the parameters'
  gradients (one vector) within 1e-6 of the uncut ones, relative, in the
  L2 norm (f32; the cut norms take their statistics from sums over the
  slabs, BatchNorm E[x^2] - E[x]^2 as uncut, and the gradients are summed
  over the ranks), the running statistics at rtol 1e-6, atol 1e-7;
  the loss of the backward is sum_k mean(sin(3 out_k)); `cut_mean`'s
  shares within 1e-7 of the whole mean;
- the steps against JAX: losses within 1e-6 and the parameters' L1 norm
  within 1e-6 relative (the JAX test's bounds, and the multi-process
  diffusion check's: tests/test_torch_distributed.py), every parameter
  and buffer within atol 1e-6 + rtol 1e-4 (tests/test_torch_parallel.py's,
  for the two frameworks' sums in another order). Adam runs with lr 1e-4 and eps
  1e-3, as tests/test_torch_adversarial.py's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from generativemodels_tpu import engines as jengines
from generativemodels_tpu.networks import zoo_convert
from generativemodels_tpu.networks.nets import VQVAE as JaxVQVAE
from generativemodels_tpu.networks.nets import AutoencoderKL as JaxAEKL
from generativemodels_tpu.networks.nets import PatchDiscriminator as JaxPatch
from generativemodels_tpu.recipes import train_vqgan as jvqgan
from generativemodels_tpu_torch.data import training_stream
from generativemodels_tpu_torch.networks import (
    autoencoderkl_state_dict_from_jax,
    patchgan_state_dict_from_jax,
    vqvae_state_dict_from_jax,
)
from generativemodels_tpu_torch.networks.nets import VQVAE, AutoencoderKL, PatchDiscriminator

from .test_torch_adversarial import EPS, LR, jax_stage1_step
from . import torch_dist_workers as workers
from .test_torch_distributed import l1_norm, spawn
from .test_torch_patchgan import random_stats
from .test_torch_unet import random_params
from .test_torch_vqvae import random_codebook
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LAYER_TOL = 1e-6
LOSS_ATOL = 1e-6
NORM_RTOL = 1e-6
KL_WEIGHT, ADV_WEIGHT, FM_WEIGHT = 1e-2, 0.5, 0.5
BATCH = 2

AEKL = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=(8, 8), attention_levels=(False, True), latent_channels=3,
            norm_num_groups=8, with_encoder_nonlocal_attn=False,
            with_decoder_nonlocal_attn=False)
DISC = dict(spatial_dims=2, num_channels=8, in_channels=1, num_layers_d=2)
VQ = dict(spatial_dims=2, in_channels=1, out_channels=1, num_channels=(8, 8), num_res_layers=1,
          num_res_channels=(8, 8), num_embeddings=16, embedding_dim=4,
          downsample_parameters=((2, 4, 1, 1),) * 2, upsample_parameters=((2, 4, 1, 1, 0),) * 2)

# (name, ConvTransposeND kwargs, input shape)
CONV_TRANSPOSE = [
    ("vqvae_up", dict(spatial_dims=2, in_channels=4, features=3, kernel_size=4, strides=2,
                      padding=1), (2, 4, 8, 6)),
    ("aekl_up_3d", dict(spatial_dims=3, in_channels=4, features=3, kernel_size=3, strides=2,
                        padding=1, output_padding=1), (2, 4, 4, 4, 4)),
    ("longer", dict(spatial_dims=2, in_channels=4, features=3, kernel_size=3, strides=2),
     (2, 4, 8, 6)),
    ("stride1", dict(spatial_dims=2, in_channels=4, features=3, kernel_size=4, padding=1),
     (2, 4, 8, 6)),
]
PATCHGAN = [
    ("instance", dict(DISC, norm="INSTANCE"), (BATCH, 1, 16, 16)),
    ("batch", dict(DISC, norm="BATCH", norm_axis_name="data"), (BATCH, 1, 16, 16)),
    ("group", dict(DISC, norm=("GROUP", {"num_groups": 4})), (BATCH, 1, 16, 16)),
    ("instance_3d", dict(DISC, spatial_dims=3, norm="INSTANCE"), (BATCH, 1, 16, 16, 16)),
]
MULTISCALE = [
    ("avg", dict(num_d=2, num_layers_d=1, spatial_dims=2, num_channels=8, in_channels=1,
                 pooling_method="avg", norm="INSTANCE", minimum_size_im=16), (BATCH, 1, 16, 16)),
]
# (name, shape, planes each rank holds)
INSTANCE_NORM = [("uneven", (2, 3, 5, 4), [3, 2]), ("one_voxel", (2, 3, 1, 1), [1, 0])]
GROUP_NORM = [("uneven", (2, 4, 5, 4), [3, 2])]
BATCH_NORM = [("uneven", (2, 4, 5, 3), [3, 2])]
# the fused 3D ResnetBlock route (kernel 5's halo slabs) in training
FUSED_UNET = [("3d", dict(spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
                          num_channels=(8, 8), attention_levels=(False, False),
                          norm_num_groups=8), (2, 1, 8, 8, 8), np.array([3, 700], np.int64))]
LAYERS = ([f"conv_transpose_{c[0]}" for c in CONV_TRANSPOSE]
          + [f"patchgan_{c[0]}" for c in PATCHGAN] + [f"multiscale_{c[0]}" for c in MULTISCALE]
          + [f"instance_norm_{c[0]}" for c in INSTANCE_NORM]
          + [f"group_norm_{c[0]}" for c in GROUP_NORM]
          + [f"batch_norm_{c[0]}" for c in BATCH_NORM] + [f"fused_unet_{c[0]}" for c in FUSED_UNET])


def _rand(shape, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _np_state(state: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in state.items()}


def _param_names(module) -> list[str]:
    return [name for name, _ in module.named_parameters()]


def _adversarial_inputs():
    """The JAX AEKL and PatchGAN with random weights, the port's state dicts
    of them, and the global batch."""
    x = np.random.RandomState(61).rand(BATCH, 1, 16, 16).astype(np.float32)
    jaekl = JaxAEKL(**AEKL)
    g_params = random_params(zoo_convert.params_structure(
        jaekl, jnp.asarray(x), method=JaxAEKL.reconstruct), 62)
    port = AutoencoderKL(**AEKL)
    g_state = autoencoderkl_state_dict_from_jax(g_params, port.state_dict(),
                                                AEKL["num_channels"], AEKL["num_res_blocks"],
                                                AEKL["attention_levels"], False, False)
    d_cfg = dict(DISC, norm="BATCH", norm_axis_name="data")
    jdisc = JaxPatch(**{k: v for k, v in d_cfg.items() if k != "norm_axis_name"})
    variables = zoo_convert.variables_structure(jdisc, jnp.asarray(x))
    d_params = random_params(variables["params"], 63)
    d_stats = random_stats(variables["batch_stats"], 64)
    disc = PatchDiscriminator(**d_cfg)
    d_state = patchgan_state_dict_from_jax(d_params, disc.state_dict(), d_stats)
    inputs = dict(g_cfg=AEKL, d_cfg=d_cfg, g_state=_np_state(g_state),
                  d_state=_np_state(d_state), x=x, seed=65, lr=LR, eps=EPS,
                  kl_weight=KL_WEIGHT, adv_weight=ADV_WEIGHT)
    return inputs, (jaekl, g_params, jdisc, d_params, d_stats)


def _adversarial_reference(inputs, jax_models) -> dict:
    """The JAX stage-1 step on the whole batch, its latent noise the port's
    single-device draw from the same seed."""
    jaekl, g_params, jdisc, d_params, d_stats = jax_models
    x = inputs["x"]
    eps = torch.randn((BATCH, 3, 8, 8), generator=torch.Generator().manual_seed(inputs["seed"]))
    tx, step = jax_stage1_step(jaekl, jdisc, KL_WEIGHT, ADV_WEIGHT)
    jstate = jengines.AdversarialTrainState(
        g_params=g_params, g_model_state={}, g_opt_state=tx.init(g_params),
        d_params=d_params, d_model_state=d_stats, d_opt_state=tx.init(d_params),
        step=jnp.asarray(0))
    jstate, out = step(jstate, (jnp.asarray(x), jnp.asarray(eps.numpy())), jnp.asarray(x),
                       jax.random.PRNGKey(0))
    aekl, disc = AutoencoderKL(**AEKL), PatchDiscriminator(**inputs["d_cfg"])
    g = autoencoderkl_state_dict_from_jax(jstate.g_params, aekl.state_dict(),
                                          AEKL["num_channels"], AEKL["num_res_blocks"],
                                          AEKL["attention_levels"], False, False)
    d = patchgan_state_dict_from_jax(jstate.d_params, disc.state_dict(), jstate.d_model_state)
    return dict(losses={str(k): float(v) for k, v in out.items()
                        if getattr(v, "ndim", None) == 0},
                g=_np_state(g), d=_np_state(d), g_norm=l1_norm(jstate.g_params),
                d_norm=l1_norm(jstate.d_params), g_params=_param_names(aekl),
                d_params=_param_names(disc))


def _vqgan_inputs():
    x = np.random.RandomState(71).rand(BATCH, 1, 16, 16).astype(np.float32)
    jvq = JaxVQVAE(**VQ)
    struct = zoo_convert.variables_structure(jvq, jnp.asarray(x))
    g_params = random_params(struct["params"], 72)
    codebook = {"quantizer": {"quantizer": random_codebook(73)}}
    vq = VQVAE(**VQ)
    vq_state = vqvae_state_dict_from_jax(g_params, codebook, vq.state_dict(), (8, 8), 1)
    d_cfg = dict(DISC, norm="INSTANCE")
    jdisc = JaxPatch(**d_cfg)
    d_params = random_params(zoo_convert.variables_structure(jdisc, jnp.asarray(x))["params"],
                             74)
    disc = PatchDiscriminator(**d_cfg)
    d_state = patchgan_state_dict_from_jax(d_params, disc.state_dict())
    inputs = dict(vq_cfg=VQ, d_cfg=d_cfg, vq_state=_np_state(vq_state),
                  d_state=_np_state(d_state), x=x, lr=LR, eps=EPS, adv_weight=ADV_WEIGHT,
                  fm_weight=FM_WEIGHT)
    return inputs, (jvq, g_params, codebook, jdisc, d_params)


def _vqgan_reference(inputs, jax_models) -> dict:
    jvq, g_params, codebook, jdisc, d_params = jax_models
    tx = optax.adam(LR, eps=EPS)
    step = jvqgan.make_vqgan_step(jvq, jdisc, tx, tx, adv_weight=ADV_WEIGHT,
                                  fm_weight=FM_WEIGHT)
    jstate = jvqgan.VQGANState(g_params=g_params, codebook=codebook,
                               g_opt_state=tx.init(g_params), d_params=d_params,
                               d_opt_state=tx.init(d_params), step=jnp.asarray(0))
    jstate, out = step(jstate, jnp.asarray(inputs["x"]))
    vq, disc = VQVAE(**VQ), PatchDiscriminator(**inputs["d_cfg"])
    g = vqvae_state_dict_from_jax(jstate.g_params, jstate.codebook, vq.state_dict(), (8, 8), 1)
    d = patchgan_state_dict_from_jax(jstate.d_params, disc.state_dict())
    return dict(losses={k: float(v) for k, v in out.items()}, g=_np_state(g), d=_np_state(d),
                g_norm=l1_norm(jstate.g_params), d_norm=l1_norm(jstate.d_params),
                g_params=_param_names(vq), d_params=_param_names(disc))


@pytest.fixture(scope="module")
def space_cut(tmp_path_factory):
    """One two-rank spawn of every check, with the JAX references."""
    tmp = tmp_path_factory.mktemp("space_cut")
    files = tmp / "files"
    files.mkdir()
    for i in range(8):
        np.save(files / f"img{i}.npy", np.full((4, 6), float(i), np.float32))
    adversarial, jax_adversarial = _adversarial_inputs()
    vqgan, jax_vqgan = _vqgan_inputs()
    seed = iter(range(80, 200))
    layers = dict(
        conv_transpose=[(n, cfg, _rand(shape, next(seed))) for n, cfg, shape in CONV_TRANSPOSE],
        patchgan=[(n, cfg, _rand(shape, next(seed))) for n, cfg, shape in PATCHGAN],
        multiscale=[(n, cfg, _rand(shape, next(seed))) for n, cfg, shape in MULTISCALE],
        instance_norm=[(n, _rand(shape, next(seed)) + 0.5, sizes)
                       for n, shape, sizes in INSTANCE_NORM],
        group_norm=[(n, _rand(shape, next(seed)) + 0.5, sizes) for n, shape, sizes in GROUP_NORM],
        batch_norm=[(n, _rand(shape, next(seed)) * 2 + 0.3, sizes)
                    for n, shape, sizes in BATCH_NORM],
        fused_unet=[(n, cfg, _rand(shape, next(seed)), t) for n, cfg, shape, t in FUSED_UNET],
    )
    inputs = dict(layers=layers, cut_mean=dict(x=_rand((2, 3, 4, 5), 90), sizes=[3, 1]),
                  adversarial=adversarial, vqgan=vqgan,
                  batches=dict(dir=str(files), shape=(4, 6), batch=4))
    outs = spawn("space_cut", 2, inputs, tmp)
    refs = dict(adversarial=_adversarial_reference(adversarial, jax_adversarial),
                vqgan=_vqgan_reference(vqgan, jax_vqgan),
                rows=[float(np.ravel(a)[0]) for a, _ in zip(
                    training_stream(str(files), (4, 6), process_index=0, process_count=1),
                    range(8))])
    return outs, refs


def _checked(outs, name: str) -> list[dict]:
    got = [o[name] for o in outs]
    for rank, g in enumerate(got):
        assert "error" not in g, f"rank {rank}: {g.get('error')}"
    return got


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Within LAYER_TOL of the uncut value, relative, in the L2 norm."""
    assert got.shape == want.shape, what
    diff = np.linalg.norm((got - want).astype(np.float64).ravel())
    norm = np.linalg.norm(want.astype(np.float64).ravel())
    assert diff <= LAYER_TOL * norm, f"{what}: |got - want| / |want| = {diff / norm:.3e}"


@pytest.mark.parametrize("layer", LAYERS)
def test_cut_layer_matches_the_uncut_module(space_cut, layer):
    """The ranks' pieces of every output tile the uncut module's output along
    axis 2, each computed once; the input gradient's pieces tile the uncut
    one; the parameters' gradients summed over the ranks and the buffers
    (BatchNorm's running statistics) are the uncut module's."""
    outs, _ = space_cut
    ranks = [g[layer] for g in _checked(outs, "layers")]
    for rank, r in enumerate(ranks):
        assert "error" not in r, f"rank {rank}: {r.get('error')}"
    whole = ranks[0]["whole"]
    for k, want in enumerate(whole["out"]):
        got = np.concatenate([r["cut"]["out"][k] for r in ranks], axis=2)
        _close(got, want, f"output {k}")
    _close(np.concatenate([r["cut"]["dx"] for r in ranks], axis=2), whole["dx"], "input grad")
    names = sorted(whole["grads"])
    for r in ranks:
        assert sorted(r["cut"]["grads"]) == names
        if names:  # the parameters' gradients as one vector
            _close(np.concatenate([r["cut"]["grads"][n].ravel() for n in names]),
                   np.concatenate([whole["grads"][n].ravel() for n in names]), "param grads")
        for name, want in whole["buffers"].items():
            np.testing.assert_allclose(r["cut"]["buffers"][name], want, rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def test_cut_patchgan_slabs_are_uneven(space_cut):
    """The PatchGAN's stride-1 layers leave the last rank fewer planes (at
    16 pixels none of the prediction's two): every plane computed once."""
    outs, _ = space_cut
    ranks = [g["layers"]["patchgan_instance"]["cut"]["out"] for g in outs]
    assert [[o.shape[2] for o in r] for r in ranks] == [[4, 2, 2, 2], [4, 2, 1, 0]]


def test_cut_mean_adds_up_to_the_whole_mean(space_cut):
    outs, _ = space_cut
    ranks = _checked(outs, "cut_mean")
    for r in ranks:
        assert abs(r["total"] - r["whole"]) < 1e-7
        np.testing.assert_allclose(r["grad"], r["whole_grad"], rtol=1e-6)


@pytest.mark.parametrize("step", ["adversarial", "vqgan"])
def test_cut_step_matches_jax_full_batch(space_cut, step):
    outs, refs = space_cut
    ref = refs[step]
    for got in _checked(outs, step):
        assert got["losses"].keys() == ref["losses"].keys()
        for key, want in ref["losses"].items():
            assert abs(got["losses"][key] - want) < LOSS_ATOL, key
        for part in ("g", "d"):
            params = {k: v for k, v in got[part].items() if k in ref[part]}
            assert params.keys() == ref[part].keys()
            for name, want in ref[part].items():
                if name.endswith("num_batches_tracked"):
                    continue
                np.testing.assert_allclose(params[name], want, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{part}: {name}")
        # the L1 norms over the trained parameters (buffers: the codebook and
        # BatchNorm's statistics are held above)
        for part in ("g", "d"):
            norm = float(sum(np.abs(got[part][n].astype(np.float64)).sum()
                             for n in ref[f"{part}_params"]))
            assert abs(norm - ref[f"{part}_norm"]) / ref[f"{part}_norm"] < NORM_RTOL, part


def test_multihost_batches_replicate_rows_over_space(space_cut):
    """Both ranks of the space group hold the same rows, in the order one
    process reads the files; a cut step takes each rank's slab of them."""
    outs, refs = space_cut
    ranks = _checked(outs, "batches")
    for r in ranks:
        assert r["rows"] == refs["rows"]
        assert r["shape"] == (4, 1, 4, 6)
        assert r["slab"] == (4, 1, 2, 6)


ONE_PROCESS_UNET = dict(spatial_dims=2, in_channels=1, out_channels=1, num_res_blocks=1,
                        num_channels=(8, 16), attention_levels=(False, True),
                        norm_num_groups=8, num_head_channels=8)


def _one_process_diffusion(mesh) -> dict:
    from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet
    from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler
    from generativemodels_tpu_torch.parallel import init_train_state, make_diffusion_train_step

    torch.manual_seed(91)
    model = DiffusionModelUNet(**ONE_PROCESS_UNET).train()
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=LR, eps=EPS))
    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000), mesh=mesh,
                                     spatial_shard_axis=None if mesh is None else 2)
    x = torch.from_numpy(_rand((BATCH, 1, 16, 16), 92))
    _, loss = step(state, x, torch.Generator().manual_seed(93))
    return {"losses": {"loss": float(loss)}, "g": _np_state(model.state_dict()), "d": {}}


@pytest.mark.parametrize("step", ["diffusion", "adversarial", "vqgan"])
def test_cut_step_on_one_process(step):
    """A cut step on a mesh of one process, {"data": 1, "space": 1}, which
    has no process group: the uncut step's losses and parameters (the cut
    norms take their statistics in another order)."""
    from generativemodels_tpu_torch.parallel import create_mesh

    run = dict(diffusion=_one_process_diffusion,
               adversarial=lambda mesh: workers._cut_adversarial(mesh, _adversarial_inputs()[0]),
               vqgan=lambda mesh: workers._cut_vqgan(mesh, _vqgan_inputs()[0]))[step]
    got = run(create_mesh({"data": 1, "space": 1}, device="cpu"))
    want = run(None)
    assert got["losses"].keys() == want["losses"].keys()
    for key, value in want["losses"].items():
        assert abs(got["losses"][key] - value) <= LOSS_ATOL * max(1.0, abs(value)), key
    for part in ("g", "d"):
        assert got[part].keys() == want[part].keys()
        for name, value in want[part].items():
            np.testing.assert_allclose(got[part][name], value, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{part}: {name}")
