"""Rank bodies of the port's multi-process tests.

tests/test_torch_distributed.py::spawn starts one process a rank:

    python -m tests.torch_dist_workers CASE RANK WORLD STORE INPUTS OUTPUT

Each joins a `gloo` group through a file store, runs CASE on the pickled
inputs with one torch thread, and pickles its results (numpy arrays, keyed
by check) to OUTPUT. This module imports only torch, numpy and the port:
the JAX references are computed by the tests, in the pytest process.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from generativemodels_tpu_torch.parallel import (
    create_mesh,
    init_train_state,
    initialize_multihost,
    make_diffusion_train_step,
    shard_batch,
    shard_params,
    spatial_cut,
    spatial_sharding,
)

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _params(model) -> dict:
    return {k: _np(v) for k, v in model.state_dict().items()}


def _unet(cfg: dict, state: dict):
    from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet

    model = DiffusionModelUNet(**cfg)
    model.load_state_dict({k: _t(v) for k, v in state.items()})
    return model


def _cut(mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's rows and slab of axis 2 of a global array (all of it
    without a mesh)."""
    return _t(x) if mesh is None else spatial_sharding(mesh, x.ndim).shard(_t(x))


# ---------------------------------------------------------------- attention


def _attention_check(mesh, c: dict) -> dict:
    from generativemodels_tpu_torch.ops import dot_product_attention, sequence_sharding

    n, r = mesh.axis_size("space"), mesh.index("space")
    d, i = mesh.axis_size("data"), mesh.index("data")

    def local(x, cut_seq=True):
        x = _t(x)
        if x.shape[0] % d == 0:
            x = x.chunk(d)[i]
        return x.chunk(n, 1)[r] if cut_seq else x

    q = local(c["q"]).requires_grad_(c["grad"])
    k = local(c["k"], c["kind"] != "cross").requires_grad_(c["grad"])
    v = local(c["v"], c["kind"] != "cross").requires_grad_(c["grad"])
    mask = _t(c["mask"]) if c["kind"] == "masked" else None
    with sequence_sharding(mesh, impl=c["impl"], causal_layout=c["layout"]):
        out = dot_product_attention(q, k, v, c["heads"], causal=c["causal"], mask=mask)
    res = {"out": _np(out)}
    if c["grad"]:
        (out**2).sum().backward()
        res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
    return res


@case
def attention(inputs: dict) -> dict:
    """Every check on its mesh; the rank's output (and input gradients)
    for its rows and sequence block."""
    meshes = [create_mesh(shape, device="cpu") for shape in inputs["meshes"]]
    results = {"coords": [m.coords for m in meshes]}
    for c in inputs["checks"]:
        results[c["name"]] = _attention_check(meshes[c["mesh"]], c)
    return results


# ---------------------------------------------------------------- training


def _state(inputs: dict, ema: bool = False):
    model = _unet(inputs["cfg"], inputs["state"]).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=inputs["lr"], eps=inputs["eps"])
    return init_train_state(model, optimizer, ema=ema)


def _step_outputs(state, loss) -> dict:
    out = {"loss": float(loss), "params": _params(state.model)}
    if state.ema_params is not None:
        out["ema"] = {k: _np(v) for k, v in state.ema_params.items()}
    return out


def _sched():
    from generativemodels_tpu_torch.networks.schedulers import DDPMScheduler

    return DDPMScheduler(num_train_timesteps=1000)


@case
def data_parallel(inputs: dict) -> dict:
    """On a {"data": 2} mesh: the step with the given (JAX) draws, with
    accumulation, with the EMA, and with its own draws; the synced
    BatchNorm, the codebook all-reduce and the adversarial and VQ-GAN steps
    under the mesh."""
    mesh = create_mesh({"data": torch.distributed.get_world_size()}, device="cpu")
    rows = lambda a: shard_batch(_t(a), mesh)  # noqa: E731
    images, noise, t = (rows(inputs[k]) for k in ("images", "noise", "timesteps"))
    res = {}
    for name, kw in (("dp", {}), ("acc", {"accumulate_steps": 2}), ("ema", {"ema_decay": 0.9})):
        state = _state(inputs, ema="ema_decay" in kw)
        shard_params(state.model, mesh)
        step = make_diffusion_train_step(_sched(), mesh=mesh, **kw)
        res[name] = _step_outputs(*step.update(state, images, noise, t))
    state = _state(inputs)
    step = make_diffusion_train_step(_sched(), mesh=mesh)
    res["drawn"] = _step_outputs(
        *step(state, images, torch.Generator().manual_seed(inputs["seed"])))
    res["bn"] = _synced_batchnorm(mesh, inputs["bn"])
    res["codebook"] = _codebook(mesh, inputs["codebook"])
    res["adversarial"] = _adversarial(mesh, inputs["adversarial"])
    res["vqgan"] = _vqgan(mesh, inputs["vqgan"])
    return res


def _synced_batchnorm(mesh, c: dict) -> dict:
    from generativemodels_tpu_torch.networks.nets import PatchDiscriminator

    disc = PatchDiscriminator(**c["cfg"], norm_axis_name="data")
    disc.load_state_dict({k: _t(v) for k, v in c["state"].items()})
    disc.train()
    with mesh:
        outs = disc(shard_batch(_t(c["x"]), mesh))
    return {"out": _np(outs[-1]), "state": _params(disc)}


def _codebook(mesh, c: dict) -> dict:
    from generativemodels_tpu_torch.networks.layers import EMAQuantizer

    q = EMAQuantizer(**c["cfg"], ddp_sync=True, axis_name="data")
    q.load_state_dict({k: _t(v) for k, v in c["state"].items()})
    with mesh:
        q(shard_batch(_t(c["x"]), mesh), train=True)
    return _params(q)


def _adversarial_models(c: dict):
    from generativemodels_tpu_torch.networks.nets import AutoencoderKL, PatchDiscriminator

    g = AutoencoderKL(**c["g_cfg"])
    g.load_state_dict({k: _t(v) for k, v in c["g_state"].items()})
    d = PatchDiscriminator(**c["d_cfg"])
    d.load_state_dict({k: _t(v) for k, v in c["d_state"].items()})
    return g.train(), d.train()


def adversarial_step(c: dict, g, d, images, eps, mesh=None):
    """The adversarial step the tests hold: AEKL G (its latent draw given),
    PatchGAN D with synced BatchNorm; returns (state, outputs)."""
    from generativemodels_tpu_torch.engines.trainer import (
        init_adversarial_state,
        make_adversarial_train_step,
    )
    from generativemodels_tpu_torch.losses import PatchAdversarialLoss

    adv = PatchAdversarialLoss(criterion="least_squares")

    def g_forward(model, inputs, generator):
        z_mu, z_sigma = model.encode(inputs)
        return model.decode(z_mu + z_sigma * eps)

    step = make_adversarial_train_step(
        g_forward, lambda model, x: model(x)[-1],
        recon_loss_fn=lambda fakes, targets: torch.mean(torch.abs(fakes - targets)),
        g_loss_fn=lambda logits: adv(logits, True, False),
        d_loss_fn=lambda real, fake: 0.5 * (adv(real, True, True) + adv(fake, False, True)),
        adv_weight=0.1, mesh=mesh,
    )
    state = init_adversarial_state(g, torch.optim.Adam(g.parameters(), lr=1e-3, eps=1e-3),
                                   d, torch.optim.Adam(d.parameters(), lr=1e-3, eps=1e-3))
    return step(state, images, images)


def _adversarial(mesh, c: dict) -> dict:
    g, d = _adversarial_models(c)
    shard_params(g, mesh)
    _, out = adversarial_step(c, g, d, shard_batch(_t(c["x"]), mesh),
                              shard_batch(_t(c["eps"]), mesh), mesh)
    return {"losses": {str(k): float(v) for k, v in out.items() if v.ndim == 0},
            "g": _params(g), "d": _params(d)}


def vqgan_models(c: dict):
    from generativemodels_tpu_torch.networks.nets import VQVAE, PatchDiscriminator

    vq = VQVAE(**c["vq_cfg"], axis_name="data")
    vq.load_state_dict({k: _t(v) for k, v in c["vq_state"].items()})
    d = PatchDiscriminator(**c["d_cfg"])
    d.load_state_dict({k: _t(v) for k, v in c["d_state"].items()})
    return vq.train(), d.train()


def vqgan_step(vq, d, images, mesh=None):
    from generativemodels_tpu_torch.recipes.train_vqgan import VQGANState, make_vqgan_step

    state = VQGANState(vq, torch.optim.Adam(vq.parameters(), lr=1e-3, eps=1e-3),
                       d, torch.optim.Adam(d.parameters(), lr=1e-3, eps=1e-3), 0)
    return make_vqgan_step(adv_weight=0.1, mesh=mesh)(state, images)


def _vqgan(mesh, c: dict) -> dict:
    vq, d = vqgan_models(c)
    _, out = vqgan_step(vq, d, shard_batch(_t(c["x"]), mesh), mesh)
    return {"losses": {k: float(v) for k, v in out.items()}, "g": _params(vq),
            "d": _params(d)}


@case
def data_space(inputs: dict) -> dict:
    """On a {"data": 2, "space": 2} mesh: the cut train step with the given
    draws, the cut UNet forward (2D, and 3D through the fused ResnetBlock),
    the cut AEKL encode and decode, and the guided latent sampler with its
    decode, cut and whole."""
    mesh = create_mesh({"data": 2, "space": 2}, device="cpu")
    res = {"coords": mesh.coords}
    state = _state(inputs)
    shard_params(state.model, mesh)
    step = make_diffusion_train_step(_sched(), mesh=mesh, spatial_shard_axis=2)
    images, noise = _cut(mesh, inputs["images"]), _cut(mesh, inputs["noise"])
    t = shard_batch(_t(inputs["timesteps"]), mesh)
    res["step"] = _step_outputs(*step.update(state, images, noise, t))

    with torch.no_grad(), spatial_cut(mesh):
        model = _unet(inputs["cfg"], inputs["state"]).eval()
        res["unet"] = _np(model(_cut(mesh, inputs["x"]), shard_batch(_t(inputs["t"]), mesh)))
        f = inputs["fused"]
        model = _unet(f["cfg"], f["state"]).eval()
        os.environ["GMTPU_FUSED_RESBLOCK"] = "1"
        try:
            res["fused"] = _np(model(_cut(mesh, f["x"]), shard_batch(_t(f["t"]), mesh)))
        finally:
            os.environ.pop("GMTPU_FUSED_RESBLOCK")
        aekl = _aekl(inputs["aekl"])
        res["decode"] = _np(aekl.decode(_cut(mesh, inputs["aekl"]["z"])))
        res["encode"] = _np(aekl.encode(_cut(mesh, inputs["aekl"]["x"]))[0])
    res["guided"] = _guided(mesh, inputs["guided"])
    return res


def _aekl(c: dict):
    from generativemodels_tpu_torch.networks.nets import AutoencoderKL

    aekl = AutoencoderKL(**c["cfg"])
    aekl.load_state_dict({k: _t(v) for k, v in c["state"].items()})
    return aekl.eval()


def _guided(mesh, c: dict) -> dict:
    """The guided latent sampler (DDIM, then DPM-Solver++) and the decode,
    on a cut latent and, on this rank alone, on the whole one."""
    from generativemodels_tpu_torch.networks.schedulers import (
        DDIMScheduler,
        DPMSolverMultistepScheduler,
    )
    from generativemodels_tpu_torch.recipes.guidance import sample_with_guidance

    unet = _unet(c["cfg"], c["state"]).eval()
    aekl = _aekl(c["aekl"])
    fn = lambda x, t, context: unet(x, t, context=context)  # noqa: E731
    out = {}
    for name, cls in (("ddim", DDIMScheduler), ("dpm", DPMSolverMultistepScheduler)):
        sched = cls(num_train_timesteps=100)
        sched.set_timesteps(4)
        with torch.no_grad():
            whole = aekl.decode(sample_with_guidance(
                fn, sched, _t(c["noise"]), _t(c["ctx"]), torch.zeros_like(_t(c["ctx"])),
                guidance_scale=3.0) / 0.42)
            with spatial_cut(mesh):
                ctx = shard_batch(_t(c["ctx"]), mesh)
                cut = aekl.decode(sample_with_guidance(
                    fn, sched, _cut(mesh, c["noise"]), ctx, torch.zeros_like(ctx),
                    guidance_scale=3.0) / 0.42)
        out[name] = {"whole": _np(whole), "cut": _np(cut)}
    return out


# ---------------------------------------------------------------- space cut


def _pieces(x: torch.Tensor, sizes) -> torch.Tensor:
    """This rank's piece of axis 2 when the space ranks hold `sizes` planes."""
    r = torch.distributed.get_rank()
    return x.narrow(2, sum(sizes[:r]), sizes[r])


def _sum_grads(module, group) -> dict:
    """The module's parameter gradients summed over the group's ranks."""
    out = {}
    for name, p in module.named_parameters():
        g = p.grad.clone() if p.grad is not None else torch.zeros_like(p)
        torch.distributed.all_reduce(g, group=group)
        out[name] = _np(g)
    return out


def _cut_and_whole(mesh, build, x: np.ndarray, sizes=None, enter_mesh=False) -> dict:
    """The module from `build()` on this rank's piece of x under the cut and,
    as a second copy, on the whole of x: outputs (a tensor or a list),
    the input's gradient and the parameters' gradients (summed over the
    ranks) of the loss sum_k mean(sin(3 out_k)) (`cut_mean` under the cut;
    a normalised output's mean square would have no gradient), and the
    buffers after the call."""
    from contextlib import ExitStack

    from generativemodels_tpu_torch.parallel.spatial import cut_mean

    res = {}
    for name in ("whole", "cut"):
        module = build()
        xt = _t(x)
        if name == "cut":
            n = mesh.axis_size("space")
            xt = _pieces(xt, sizes or [x.shape[2] // n] * n)
        xt = xt.clone().requires_grad_()
        with ExitStack() as stack:
            if name == "cut":
                if enter_mesh:
                    stack.enter_context(mesh)
                stack.enter_context(spatial_cut(mesh))
            out = module(xt)
            outs = out if isinstance(out, list) else [out]
            loss = sum(cut_mean(torch.sin(3 * o.float())) for o in outs)
            loss.backward()
        res[name] = dict(out=[_np(o) for o in outs], dx=_np(xt.grad),
                         grads=(_sum_grads(module, mesh.group("space")) if name == "cut"
                                else {k: _np(p.grad) for k, p in module.named_parameters()}),
                         buffers={k: _np(b) for k, b in module.named_buffers()})
    return res


def _seeded_module(cls, seed: int, **cfg):
    def build():
        torch.manual_seed(seed)
        return cls(**cfg).train()
    return build


def _layer_checks(mesh, c: dict) -> dict:
    """The cut layers, each against the uncut module on this rank (a layer
    that raises reports its error)."""
    from generativemodels_tpu_torch.networks.blocks.convolutions import ConvTransposeND
    from generativemodels_tpu_torch.networks.nets import (
        MultiScalePatchDiscriminator,
        PatchDiscriminator,
    )
    from generativemodels_tpu_torch.networks.nets.patchgan_discriminator import (
        BatchNormND,
        _InstanceNorm,
    )

    def batch_norm(channels):
        def build():
            torch.manual_seed(4)
            m = BatchNormND(channels, eps=1e-5, momentum=0.1, axis_name="data")
            torch.nn.init.normal_(m.weight, 1.0, 0.1)
            torch.nn.init.normal_(m.bias, 0.0, 0.1)
            return m.train()
        return build

    def group_norm(channels):
        def build():
            from generativemodels_tpu_torch.networks.blocks.layers import GroupNorm

            torch.manual_seed(6)
            m = GroupNorm(2, channels)
            torch.nn.init.normal_(m.weight, 1.0, 0.1)
            torch.nn.init.normal_(m.bias, 0.0, 0.1)
            return m
        return build

    checks = (
        [(f"conv_transpose_{name}", (_seeded_module(ConvTransposeND, 1, **cfg), x), {})
         for name, cfg, x in c["conv_transpose"]]
        + [(f"patchgan_{name}", (_seeded_module(PatchDiscriminator, 2, **cfg), x),
            dict(enter_mesh=True)) for name, cfg, x in c["patchgan"]]
        + [(f"multiscale_{name}", (_Wrap.of(MultiScalePatchDiscriminator, 3, cfg), x), {})
           for name, cfg, x in c["multiscale"]]
        + [(f"instance_norm_{name}", (_InstanceNorm, x, sizes), {})
           for name, x, sizes in c["instance_norm"]]
        + [(f"group_norm_{name}", (group_norm(x.shape[1]), x, sizes), {})
           for name, x, sizes in c["group_norm"]]
        + [(f"batch_norm_{name}", (batch_norm(x.shape[1]), x, sizes), dict(enter_mesh=True))
           for name, x, sizes in c["batch_norm"]]
        + [(f"fused_unet_{name}", (_FusedUNet.of(cfg, t), x), {})
           for name, cfg, x, t in c["fused_unet"]]
    )
    res = {}
    for name, args, kw in checks:
        try:
            res[name] = _cut_and_whole(mesh, *args, **kw)
        except Exception as exc:  # reported to the test that reads it
            res[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return res


class _FusedUNet(torch.nn.Module):
    """A 3D UNet with random weights (its zero-initialised out conv too)
    whose forward at fixed timesteps takes the fused ResnetBlock route
    (GMTPU_FUSED_RESBLOCK=1: kernel 5's plain version on the CPU)."""

    def __init__(self, cfg: dict, t) -> None:
        from generativemodels_tpu_torch.networks.nets import DiffusionModelUNet

        super().__init__()
        self.unet = DiffusionModelUNet(**cfg)
        with torch.no_grad():
            for p in self.unet.parameters():
                p.normal_(0.0, 0.2)
        self.t = _t(t)

    @classmethod
    def of(cls, cfg: dict, t):
        def build():
            torch.manual_seed(5)
            return cls(cfg, t).train()
        return build

    def forward(self, x):
        os.environ["GMTPU_FUSED_RESBLOCK"] = "1"
        try:
            return self.unet(x, self.t)
        finally:
            os.environ.pop("GMTPU_FUSED_RESBLOCK")


class _Wrap(torch.nn.Module):
    """A multi-scale discriminator whose forward returns its predictions and
    features as one list."""

    def __init__(self, inner) -> None:
        super().__init__()
        self.inner = inner

    @classmethod
    def of(cls, inner_cls, seed: int, cfg: dict):
        def build():
            torch.manual_seed(seed)
            return cls(inner_cls(**cfg)).train()
        return build

    def forward(self, x):
        outputs, features = self.inner(x)
        return list(outputs) + [f for fs in features for f in fs]


def _cut_mean_check(mesh, c: dict) -> dict:
    """The shares of `cut_mean` over pieces of unequal depth add up to the
    whole mean; each piece's gradient is the whole mean's."""
    from generativemodels_tpu_torch.parallel.spatial import cut_mean

    x = _t(c["x"])
    piece = _pieces(x, c["sizes"]).clone().requires_grad_()
    with spatial_cut(mesh):
        share = cut_mean(piece)
    share.backward()
    total = share.detach().clone().reshape(1)
    torch.distributed.all_reduce(total, group=mesh.group("space"))
    whole = x.clone().requires_grad_()
    torch.mean(whole).backward()
    return dict(total=float(total), whole=float(torch.mean(x)), grad=_np(piece.grad),
                whole_grad=_np(_pieces(whole.grad, c["sizes"])))


def _cut_adversarial(mesh, c: dict) -> dict:
    """The 3D LDM recipe's stage-1 step, 2D and tiny, under the cut (uncut
    without a mesh): its AEKL latent draw from a seeded generator (the
    global batch's, this rank's slab kept), D with BatchNorm synced over
    "data"."""
    from generativemodels_tpu_torch.engines import init_adversarial_state
    from generativemodels_tpu_torch.networks.nets import AutoencoderKL, PatchDiscriminator
    from generativemodels_tpu_torch.recipes.train_2d_ldm import make_stage1_steps

    g = AutoencoderKL(**c["g_cfg"])
    g.load_state_dict({k: _t(v) for k, v in c["g_state"].items()})
    d = PatchDiscriminator(**c["d_cfg"])
    d.load_state_dict({k: _t(v) for k, v in c["d_state"].items()})
    g.train(), d.train()
    _, step = make_stage1_steps(c["kl_weight"], c["adv_weight"], mesh=mesh,
                                spatial_shard_axis=None if mesh is None else 2)
    state = init_adversarial_state(
        g, torch.optim.Adam(g.parameters(), lr=c["lr"], eps=c["eps"]),
        d, torch.optim.Adam(d.parameters(), lr=c["lr"], eps=c["eps"]))
    images = _cut(mesh, c["x"])
    _, out = step(state, images, images, torch.Generator().manual_seed(c["seed"]))
    return {"losses": {str(k): float(v) for k, v in out.items()
                       if isinstance(v, torch.Tensor) and v.ndim == 0},
            "g": _params(g), "d": _params(d)}


def _cut_vqgan(mesh, c: dict) -> dict:
    from generativemodels_tpu_torch.recipes.train_vqgan import VQGANState, make_vqgan_step

    vq, d = vqgan_models(c)
    state = VQGANState(vq, torch.optim.Adam(vq.parameters(), lr=c["lr"], eps=c["eps"]),
                       d, torch.optim.Adam(d.parameters(), lr=c["lr"], eps=c["eps"]), 0)
    step = make_vqgan_step(adv_weight=c["adv_weight"], fm_weight=c["fm_weight"], mesh=mesh,
                           spatial_shard_axis=None if mesh is None else 2)
    _, out = step(state, _cut(mesh, c["x"]))
    return {"losses": {k: float(v) for k, v in out.items()}, "g": _params(vq),
            "d": _params(d)}


def _space_batches(mesh, c: dict) -> dict:
    """Two global batches of `multihost_device_batches` on the cut mesh:
    each row's file value, and the shape of this rank's slab of them."""
    from generativemodels_tpu_torch.data import multihost_device_batches

    it = multihost_device_batches(c["dir"], c["shape"], c["batch"], mesh)
    rows, slab = [], None
    for _ in range(2):
        b = next(it)
        rows += [float(v) for v in b[:, 0, 0, 0]]
        slab = tuple(spatial_sharding(mesh, b.ndim, data_axis=None).shard(b).shape)
    it.close()
    return dict(rows=rows, shape=tuple(b.shape), slab=slab)


@case
def space_cut(inputs: dict) -> dict:
    """On a {"data": 1, "space": 2} mesh: the cut layers against the uncut
    modules, `cut_mean`, the cut stage-1 and VQ-GAN steps, and the
    multi-process batches. A check that raises reports its error (the
    ranks raise together: each check's collectives are symmetric)."""
    mesh = create_mesh({"data": 1, "space": 2}, device="cpu")
    res = {"space": mesh.index("space")}
    for name, fn in (("layers", _layer_checks), ("cut_mean", _cut_mean_check),
                     ("adversarial", _cut_adversarial), ("vqgan", _cut_vqgan),
                     ("batches", _space_batches)):
        try:
            res[name] = fn(mesh, inputs[name])
        except Exception as exc:  # reported to the test that reads it
            res[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return res


# ---------------------------------------------------------------- processes


@case
def processes(inputs: dict) -> dict:
    """The multi-process path (tests/test_distributed.py): an all-reduce,
    the codebook, the train step, DDIM sampling of each rank's rows, the
    default file partition and the global batch."""
    from generativemodels_tpu_torch.data import file_dataset, multihost_device_batches
    from generativemodels_tpu_torch.inferers import DiffusionInferer
    from generativemodels_tpu_torch.networks.schedulers import DDIMScheduler
    from generativemodels_tpu_torch.parallel import process_count, process_index
    from generativemodels_tpu_torch.parallel.collectives import all_reduce

    rank, pc = process_index(), process_count()
    mesh = create_mesh(device="cpu")
    res = {"rank": rank, "count": pc}
    res["psum"] = float(all_reduce(torch.tensor([float(rank + 1)]), mesh.group("data")))
    res["codebook"] = _codebook(mesh, inputs["codebook"])

    state = _state(inputs)
    step = make_diffusion_train_step(_sched(), mesh=mesh)
    rows = lambda a: shard_batch(_t(a), mesh)  # noqa: E731
    state, loss = step.update(state, rows(inputs["images"]), rows(inputs["noise"]),
                              rows(inputs["timesteps"]))
    res["step"] = _step_outputs(state, loss)

    model = _unet(inputs["cfg"], inputs["state"]).eval()
    sched = DDIMScheduler(num_train_timesteps=100)
    sched.set_timesteps(10)
    with torch.no_grad():
        res["sample"] = _np(DiffusionInferer(sched).sample(
            rows(inputs["sample_noise"]), lambda x, t, context=None: model(x, t)))

    res["vals"] = [int(a[0, 0]) for a in file_dataset(inputs["part_dir"], loop=False)]
    it = multihost_device_batches(inputs["batch_dir"], (6, 6), 4, mesh)
    gb = next(it)
    it.close()
    res["local_shape"] = tuple(gb.shape)
    res["local_mean"] = float(gb.mean())
    res["global_mean"] = float(all_reduce(gb.sum().reshape(1), mesh.group("data"))) / (4 * 36)
    return res


def main() -> None:
    name, rank, world, store, in_path, out_path = sys.argv[1:]
    torch.set_num_threads(1)
    initialize_multihost(f"file://{store}", int(world), int(rank), device="cpu", timeout=100)
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    result = CASES[name](inputs)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
