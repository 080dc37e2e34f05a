"""The port's mesh paths on several cards, one rank a card, each against the
same computation on one rank.

    torchrun --nproc_per_node=4 -m generativemodels_tpu_torch.probes.multi_card \\
        --out multi_card.json

Every rank builds bench.py's 3D model (UNet (32, 64, 128), attention on the
last level, heads of 64, 128^3) from seed 0, as `recipes.train_3d_ddpm`
does, and computes each one-rank reference itself:

1. The data-parallel step on {"data": N} (one volume a rank, bf16) against
   the one-rank step with `accumulate_steps=N` on the whole batch: every
   microbatch is one volume, so each volume's gradient comes from the same
   kernels on the same shapes, and only the order of the f32 sum over
   volumes differs. Loss and gradients within 1e-6 (relative).
2. The spatially cut step on {"data": 2, "space": N/2} (batch 2) and on
   {"space": N} (batch 1), in f32 and bf16, against the uncut one-rank step
   (accumulating over the batch). f32: loss and gradient norm within 1e-5
   (relative: the slabs take other convolution algorithms and their
   GroupNorms sums over the slabs, in another order; the H100 reads 4e-7).
   bf16: within twice the uncut bf16 step's own distance from the uncut f32
   step.
3. Sequence-parallel attention at the 3D shape, (2, 32768, 32768, 64) bf16
   as B = 1 with two heads of 64, on {"space": N}: the allgather's rows
   and dq equal to the unsharded kernels' to the bit, its dk, dv (summed by
   the reduce-scatter) within 2e-2 of their largest value, and the ring's
   rows within 2e-2 of the largest |O| (bf16: a few ulps there, the chunks'
   O rounded before the merge); 1e-5 in f32.

4. The 3D LDM recipe's stage-1 G+D step (`recipes/train_3d_ldm.py`'s
   `build_models`: AEKL (32, 64, 64) with attention on its last level,
   PatchGAN 3D with instance norm; `--ldm-size` 128, batch 2, the adversarial
   step of `train_2d_ldm.make_stage1_steps`) cut on {"space": N}, in f32 and
   bf16, against the uncut step on rank 0 alone (the other ranks wait, so
   that two ranks sharing a card hold one uncut step's memory). The AEKL's
   attention level (32^3 tokens at 128^3) goes through the allgather:
   kernel 1 at Sq = S/N and kernels 2-3 in its backward, counted on each
   rank over the cut f32 step. f32: losses within 1e-5 (relative); G's and
   D's gradients within 1e-5 or twice the distance between two f32
   summation orders of the uncut step (cuDNN's convolutions and PyTorch's
   own), whichever is larger (`check_ldm_stage1` says why); bf16: gradients
   within twice the uncut bf16 step's own distance from the uncut f32 step.
   A witness at half the side (64^3; 32^3 at the least, the PatchGAN's
   smallest) holds the step in float64, cut against uncut: every leaf of
   G's and D's gradients within 1e-8, the losses within 1e-5 (the
   PatchGAN's logits are f32 by contract, so the losses are f32 sums); and
   the cut f32 step's gradients no further from the uncut float64 ones
   than 1e-5 or twice the uncut f32 step's distance from them.
5. The VQ-GAN recipe's step (`recipes/train_vqgan.py`'s `build_models`,
   64x64, batch 16, f32) cut on {"space": N} (on four or more ranks
   {"data": 2, "space": N/2}), against the uncut step on rank 0: losses,
   gradients and the EMA codebook within 1e-5 (relative).

Times: a step on the host clock after a synchronize (the mean of steps 2-4
of each run), an attention call on the host clock between barriers. Rank 0
prints one JSON line, and writes it to `--out`. Rehearse on the CPU with
gloo: `torchrun --nproc_per_node=4 -m generativemodels_tpu_torch.probes.multi_card
--device cpu --size 16 --channels 16 32 --head-channels 16 --norm-groups 8
--seq 256 --ldm-size 32 --vq-size 32 --vq-batch 4`. `--backend gloo --device cuda:0` puts every rank on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
import torch.distributed as dist

from ..networks.nets import DiffusionModelUNet
from ..networks.schedulers import DDPMScheduler
from ..ops import dot_product_attention, sequence_sharding
from ..parallel import (
    create_mesh,
    init_train_state,
    initialize_multihost,
    make_diffusion_train_step,
    process_device,
    shard_batch,
    spatial_sharding,
)

TIMED_STEPS = 3
CUT_F32_TOL = 1e-5  # relative, loss and gradient norm
F64_TOL = 1e-8  # relative: the cut float64 stage-1 step against the uncut, leaf by leaf
LDM_BATCH = 2  # the 3D LDM recipe's batch
PATCHGAN_MIN = 32  # the smallest side the recipe's PatchGAN takes
RING_BF16_TOL = 2e-2  # of the largest |O|
CHECKS = ("data_parallel", "cut_data_space", "cut_space", "attention", "ldm_stage1", "vqgan")
KERNELS_1_3 = ("FLASH_FWD", "FLASH_BWD_DQ", "FLASH_BWD_DKV")


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--channels", type=int, nargs="+", default=[32, 64, 128])
    parser.add_argument("--head-channels", type=int, default=64)
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--seq", type=int, default=32768)
    parser.add_argument("--ldm-size", type=int, default=128)
    parser.add_argument("--vq-size", type=int, default=64)
    parser.add_argument("--vq-batch", type=int, default=16)
    parser.add_argument("--checks", nargs="+", default=list(CHECKS), choices=list(CHECKS))
    parser.add_argument("--out", default=None)
    return parser.parse_args(argv)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(device.index)], capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def model(args, dtype, device) -> torch.nn.Module:
    """The recipe's 3D UNet from seed 0 (identical on every rank)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = DiffusionModelUNet(
            spatial_dims=3, in_channels=1, out_channels=1, num_res_blocks=1,
            num_channels=tuple(args.channels),
            attention_levels=(False,) * (len(args.channels) - 1) + (True,),
            num_head_channels=args.head_channels, norm_num_groups=args.norm_groups,
            dtype=dtype,
        )
    return net.to(device).train()


def volumes(args, batch: int, device) -> torch.Tensor:
    g = torch.Generator(device).manual_seed(42)
    return torch.rand((batch, 1) + (args.size,) * 3, generator=g, device=device) * 2 - 1


def run_steps(args, dtype, device, images, mesh=None, spatial=False, accumulate=1) -> dict:
    """Step 1's loss and gradients from fresh weights, then the mean host
    time of TIMED_STEPS more steps."""
    net = model(args, dtype, device)
    state = init_train_state(net, torch.optim.Adam(net.parameters(), lr=2.5e-5))
    step = make_diffusion_train_step(DDPMScheduler(num_train_timesteps=1000, device=device),
                                     mesh=mesh, spatial_shard_axis=2 if spatial else None,
                                     accumulate_steps=accumulate)
    g = torch.Generator(device).manual_seed(7)
    state, loss = step(state, images, g)
    out = dict(loss=float(loss), grad=flat_grads(net),
               step_ms=timed_steps(lambda: step(state, images, g), device))
    del state, net
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def check_data_parallel(args, device, n) -> dict:
    mesh = create_mesh({"data": n}, device=device)
    full = volumes(args, n, device)
    dp = run_steps(args, torch.bfloat16, device, shard_batch(full, mesh), mesh)
    ref = run_steps(args, torch.bfloat16, device, full, accumulate=n)
    one = run_steps(args, torch.bfloat16, device, full[:1])
    res = dict(loss_rel=abs(dp["loss"] - ref["loss"]) / abs(ref["loss"]),
               grad_rel=rel(dp["grad"], ref["grad"]), step_ms=dp["step_ms"],
               one_rank_step_ms=one["step_ms"], mesh={"data": n})
    res["ok"] = res["loss_rel"] <= 1e-6 and res["grad_rel"] <= 1e-6
    return res


def check_cut(args, device, shape: dict) -> dict:
    mesh = create_mesh(shape, device=device)
    batch = shape.get("data", 1)
    full = volumes(args, batch, device)
    local = spatial_sharding(mesh, full.ndim).shard(full)
    out = dict(mesh=shape)
    runs = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        cut = run_steps(args, dtype, device, local, mesh, spatial=True)
        ref = run_steps(args, dtype, device, full, accumulate=batch)
        runs[name] = (cut, ref)
        out[name] = dict(loss_rel=abs(cut["loss"] - ref["loss"]) / abs(ref["loss"]),
                         grad_rel=rel(cut["grad"], ref["grad"]), step_ms=cut["step_ms"],
                         uncut_step_ms=ref["step_ms"])
    own = rel(runs["bf16"][1]["grad"], runs["f32"][1]["grad"])
    out["bf16"]["uncut_bf16_vs_f32"] = own
    out["f32"]["tol"] = CUT_F32_TOL
    out["ok"] = (out["f32"]["grad_rel"] <= CUT_F32_TOL and out["f32"]["loss_rel"] <= CUT_F32_TOL
                 and out["bf16"]["grad_rel"] <= 2 * own)
    return out


def timed(fn, device, iters: int = 10) -> float:
    """ms a call, between barriers (every rank's collectives included)."""
    for _ in range(2):
        fn()
    sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    dist.barrier()
    return 1e3 * (time.perf_counter() - t0) / iters


def check_attention(args, device, n) -> dict:
    mesh = create_mesh({"space": n}, device=device)
    r, s, heads, d = mesh.index("space"), args.seq, 2, 64
    c = s // n
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    g = torch.Generator(device).manual_seed(3)
    q, k, v, dout = (torch.randn((1, s, heads * d), generator=g, device=device).to(dtype)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    full = dot_product_attention(*leaves, heads)
    (full * dout).sum().backward()
    rows = slice(r * c, (r + 1) * c)
    res = dict(mesh={"space": n}, shape=(heads, c, s, d))
    for impl in ("allgather", "ring"):
        local = [t[:, rows].detach().clone().requires_grad_(impl == "allgather")
                 for t in (q, k, v)]
        with sequence_sharding(mesh, impl=impl):
            out = dot_product_attention(*local, heads)
            res[f"{impl}_ms"] = timed(lambda: dot_product_attention(*local, heads), device)
        if impl == "allgather":
            res["allgather_equal"] = same(out, full[:, rows])
            (out * dout[:, rows]).sum().backward()
            res["dq_equal"] = same(local[0].grad, leaves[0].grad[:, rows])
            res["dkv_rel"] = max(
                float((a.grad.float() - b.grad[:, rows].float()).abs().max()
                      / b.grad[:, rows].float().abs().max())
                for a, b in zip(local[1:], leaves[1:]))
        else:
            want = full[:, rows].detach().float()
            res["ring_err"] = float((out.detach().float() - want).abs().max())
            res["ring_tol"] = (RING_BF16_TOL * float(want.abs().max())
                               if dtype == torch.bfloat16 else 1e-5)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    res["ok"] = (res["allgather_equal"] and res["dq_equal"] and res["dkv_rel"] <= tol
                 and res["ring_err"] <= res["ring_tol"])
    return res


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit on the card (the kernels walk each row's keys in one
    order whatever the rows around it); within 1e-5 on the CPU, whose plain
    matmuls block a slab of rows otherwise than the whole."""
    if a.is_cuda:
        return bool(torch.equal(a, b))
    return bool((a - b).abs().max() <= 1e-5 * b.abs().max())


def leaf_grads(*modules) -> list[torch.Tensor]:
    return [p.grad.detach().reshape(-1).clone() for m in modules for p in m.parameters()
            if p.grad is not None]


def flat_grads(*modules) -> torch.Tensor:
    return torch.cat([g.float() for g in leaf_grads(*modules)])


def leaf_rel(got: list, want: list) -> float:
    """The largest distance of a leaf from its reference, relative to the
    reference leaf's norm, or to a millionth of all leaves' norm where that
    is larger (a gradient that is ~0, as a bias's before a norm)."""
    floor = 1e-6 * float(torch.cat(want).double().norm())
    return max(float((a.double() - b.double()).norm()) / max(float(b.double().norm()), floor)
               for a, b in zip(got, want, strict=True))


def reset_launches() -> None:
    from .. import ops

    for name in KERNELS_1_3:
        getattr(ops, name).launches = 0


def read_launches() -> dict:
    from .. import ops

    return {name: getattr(ops, name).launches for name in KERNELS_1_3}


def run_stage1(dtype, device, images, mesh=None, count=False, native=False,
               timed=True) -> dict:
    """The 3D LDM recipe's adversarial stage-1 step from the recipe's seed-0
    weights and its generator seed 42: step 1's losses and G's and D's
    gradients, leaf by leaf (and, with `count`, its launches of kernels
    1-3), then, if `timed`, the mean host time of TIMED_STEPS more steps.
    `native`: PyTorch's own convolutions in place of cuDNN's (another f32
    summation order of the same step). float64: the weights and images in
    float64, the attention on its plain path (the kernels take f32 and
    bf16), and the AEKL's outputs (f32 by contract) cast back to float64
    for the losses and the PatchGAN."""
    from ..engines import init_adversarial_state
    from ..recipes.train_2d_ldm import aekl_forward, make_stage1_steps
    from ..recipes.train_3d_ldm import build_models

    wide = dtype == torch.float64
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        aekl, disc, _ = build_models(None if wide else dtype,
                                     use_flash_attention=False if wide else None)
    aekl, disc = aekl.to(device).train(), disc.to(device).train()
    g_forward = aekl_forward
    if wide:
        aekl, disc, images = aekl.double(), disc.double(), images.double()

        def g_forward(model, inputs, generator):
            return tuple(t.double() for t in aekl_forward(model, inputs, generator))

    state = init_adversarial_state(aekl, torch.optim.Adam(aekl.parameters(), lr=1e-4),
                                   disc, torch.optim.Adam(disc.parameters(), lr=1e-4))
    _, step = make_stage1_steps(1e-6, 0.01, g_forward, mesh=mesh,
                                spatial_shard_axis=None if mesh is None else 2)
    g = torch.Generator(device).manual_seed(42)
    if count:
        sync(device)
        reset_launches()
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn and not native
    try:
        state, out = step(state, images, images, g)
        sync(device)
    finally:
        torch.backends.cudnn.enabled = cudnn
    launches = read_launches() if count else None
    res = dict(losses={str(k): float(v) for k, v in out.items()
                       if isinstance(v, torch.Tensor) and v.ndim == 0},
               g_grads=leaf_grads(aekl), d_grads=leaf_grads(disc), launches=launches)
    res["g_grad"], res["d_grad"] = (torch.cat([t.float() for t in res[k]])
                                    for k in ("g_grads", "d_grads"))
    if timed:
        res["step_ms"] = timed_steps(lambda: step(state, images, images, g), device)
    del state, aekl, disc, out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def timed_steps(fn, device) -> float:
    seconds = []
    for _ in range(TIMED_STEPS):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        seconds.append(time.perf_counter() - t0)
    return 1e3 * sum(seconds[1:]) / (TIMED_STEPS - 1)


def loss_rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items())


def on_rank0(fn):
    """fn() on rank 0 alone (the others wait at a barrier); None elsewhere."""
    out = fn() if dist.get_rank() == 0 else None
    dist.barrier()
    return out


def check_ldm_stage1(args, device, shape: dict) -> dict:
    """The cut stage-1 step against the uncut one on rank 0. The f32
    gradients of this step are ill-conditioned at 128^3: the weight
    gradient of a convolution whose input has a mean far from 0 and whose
    output is normalised sums terms that cancel, so that two f32 summation
    orders of the uncut step itself disagree by ~1e-4. So the f32
    gradients are held to CUT_F32_TOL or to twice the distance between two
    f32 orders of the uncut step (cuDNN's convolutions and PyTorch's own),
    whichever is larger; the losses to CUT_F32_TOL. The witness at half the
    side holds what that cannot: the cut step's function in float64, leaf
    by leaf, and the cut f32 step as near to it as the uncut f32 step."""
    from ..recipes.train_3d_ddpm import synthetic_volume

    mesh = create_mesh(shape, device=device)
    g = torch.Generator(device).manual_seed(42)
    full = synthetic_volume(g, LDM_BATCH, args.ldm_size, device)
    local = spatial_sharding(mesh, full.ndim).shard(full)
    out = dict(mesh=shape, size=args.ldm_size, batch=LDM_BATCH)
    runs = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        cut = run_stage1(dtype, device, local, mesh, count=name == "f32")
        ref = on_rank0(lambda: run_stage1(dtype, device, full))
        runs[name] = (cut, ref)
        out[name] = dict(step_ms=cut["step_ms"])
        if name == "f32":
            out["launches"] = cut["launches"]
        if ref is not None:
            out[name].update(loss_rel=loss_rel(cut["losses"], ref["losses"]),
                             g_grad_rel=rel(cut["g_grad"], ref["g_grad"]),
                             d_grad_rel=rel(cut["d_grad"], ref["d_grad"]),
                             uncut_step_ms=ref["step_ms"])
    native = on_rank0(lambda: run_stage1(None, device, full, native=True, timed=False))
    side = max(PATCHGAN_MIN, args.ldm_size // 2)
    small = synthetic_volume(g, LDM_BATCH, side, device)
    witness = {}
    for name, dtype in (("f64", torch.float64), ("f32", None)):
        cut = run_stage1(dtype, device, spatial_sharding(mesh, small.ndim).shard(small), mesh,
                         timed=False)
        witness[name] = (cut, on_rank0(lambda: run_stage1(dtype, device, small, timed=False)))
    launched = all(v > 0 for v in out["launches"].values()) or device.type != "cuda"
    if dist.get_rank() != 0:
        out["ok"] = launched
        return out
    f32, bf16 = out["f32"], out["bf16"]
    uncut32 = runs["f32"][1]
    f32["uncut_orders"] = dict(g=rel(native["g_grad"], uncut32["g_grad"]),
                               d=rel(native["d_grad"], uncut32["d_grad"]),
                               loss=loss_rel(native["losses"], uncut32["losses"]))
    f32["tol"] = CUT_F32_TOL
    f32["g_tol"] = max(CUT_F32_TOL, 2 * f32["uncut_orders"]["g"])
    f32["d_tol"] = max(CUT_F32_TOL, 2 * f32["uncut_orders"]["d"])
    own = max(rel(runs["bf16"][1]["g_grad"], uncut32["g_grad"]),
              rel(runs["bf16"][1]["d_grad"], uncut32["d_grad"]))
    bf16["uncut_bf16_vs_f32"] = own
    (cut64, ref64), (cut32, ref32) = witness["f64"], witness["f32"]
    w = out["witness"] = dict(size=side, f64_tol=F64_TOL, f32_tol=CUT_F32_TOL)
    w["f64"] = dict(loss_rel=loss_rel(cut64["losses"], ref64["losses"]),
                    g_leaf_rel=leaf_rel(cut64["g_grads"], ref64["g_grads"]),
                    d_leaf_rel=leaf_rel(cut64["d_grads"], ref64["d_grads"]))
    w["f32"] = {}
    for part in ("g", "d"):
        truth = ref64[f"{part}_grad"].double()
        w["f32"][part] = dict(cut_vs_f64=rel(cut32[f"{part}_grad"].double(), truth),
                              uncut_vs_f64=rel(ref32[f"{part}_grad"].double(), truth),
                              cut_vs_uncut=rel(cut32[f"{part}_grad"], ref32[f"{part}_grad"]))
    out["ok"] = (f32["loss_rel"] <= CUT_F32_TOL and f32["g_grad_rel"] <= f32["g_tol"]
                 and f32["d_grad_rel"] <= f32["d_tol"]
                 and max(bf16["g_grad_rel"], bf16["d_grad_rel"]) <= 2 * own
                 and w["f64"]["loss_rel"] <= CUT_F32_TOL
                 and max(w["f64"]["g_leaf_rel"], w["f64"]["d_leaf_rel"]) <= F64_TOL
                 and all(r["cut_vs_f64"] <= max(CUT_F32_TOL, 2 * r["uncut_vs_f64"])
                         for r in w["f32"].values())
                 and launched)
    return out


def run_vqgan(args, device, images, mesh=None) -> dict:
    """The VQ-GAN recipe's adversarial step from its seed-0 weights: step 1's
    losses, gradients and codebook, then the mean host time of TIMED_STEPS
    more steps."""
    from ..recipes.train_vqgan import VQGANState, build_models, make_vqgan_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        vqvae, disc = build_models(2, (128, 256))
    vqvae.quantizer.quantizer.axis_name = "data"
    vqvae, disc = vqvae.to(device).train(), disc.to(device).train()
    state = VQGANState(vqvae, torch.optim.Adam(vqvae.parameters(), lr=1e-4),
                       disc, torch.optim.Adam(disc.parameters(), lr=5e-4), 0)
    step = make_vqgan_step(mesh=mesh, spatial_shard_axis=None if mesh is None else 2)
    state, out = step(state, images)
    sync(device)
    q = vqvae.quantizer.quantizer
    res = dict(losses={k: float(v) for k, v in out.items()}, g_grad=flat_grads(vqvae),
               d_grad=flat_grads(disc), codebook=q.embedding.weight.detach().clone())
    res["step_ms"] = timed_steps(lambda: step(state, images), device)
    del state, vqvae, disc, out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def check_vqgan(args, device, shape: dict) -> dict:
    from ..recipes.train_2d_ddpm import synthetic_batch

    mesh = create_mesh(shape, device=device)
    full = synthetic_batch(torch.Generator(device).manual_seed(42), args.vq_batch, args.vq_size,
                           device)
    cut = run_vqgan(args, device, spatial_sharding(mesh, full.ndim).shard(full), mesh)
    ref = on_rank0(lambda: run_vqgan(args, device, full))
    out = dict(mesh=shape, size=args.vq_size, batch=args.vq_batch, step_ms=cut["step_ms"])
    if ref is None:
        out["ok"] = True
        return out
    out.update(loss_rel=loss_rel(cut["losses"], ref["losses"]),
               g_grad_rel=rel(cut["g_grad"], ref["g_grad"]),
               d_grad_rel=rel(cut["d_grad"], ref["d_grad"]),
               codebook_rel=rel(cut["codebook"], ref["codebook"]),
               uncut_step_ms=ref["step_ms"], tol=CUT_F32_TOL)
    out["ok"] = max(out["loss_rel"], out["g_grad_rel"], out["d_grad_rel"],
                    out["codebook_rel"]) <= CUT_F32_TOL
    return out


def gather_ok(results: dict, device) -> bool:
    """Every rank's checks passed (the flag on the rank's device: nccl takes
    no CPU tensor)."""
    flag = torch.tensor([all(r["ok"] for r in results.values())], dtype=torch.int32,
                        device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def main(argv=None) -> dict:
    args = build_args(argv)
    rank, n = initialize_multihost(device=args.device, backend=args.backend)
    device = process_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if rank == 0:  # one build, before the others load it
            from ..ops.native import build_library

            for source in ("flash_fwd.cu", "flash_bwd.cu"):
                build_library(source)
        dist.barrier()
    t0 = time.perf_counter()
    checks = dict(
        data_parallel=lambda: check_data_parallel(args, device, n),
        cut_data_space=lambda: check_cut(args, device, {"data": 2, "space": n // 2}),
        cut_space=lambda: check_cut(args, device, {"space": n}),
        attention=lambda: check_attention(args, device, n),
        ldm_stage1=lambda: check_ldm_stage1(args, device, {"space": n}),
        vqgan=lambda: check_vqgan(args, device, {"data": 2, "space": n // 2} if n >= 4
                                  else {"space": n}),
    )
    if n < 4 or n % 2:  # {"data": 2, "space": N/2} needs a space axis of 2 or more
        checks.pop("cut_data_space")
    results = {name: fn() for name, fn in checks.items() if name in args.checks}
    cards = [None] * n
    dist.all_gather_object(cards, card(device))
    ok = gather_ok(results, device)
    line = dict(ranks=n, backend=dist.get_backend(), cards=cards, seconds=time.perf_counter() - t0,
                ok=ok, **results)
    if rank == 0:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write(text + "\n")
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(f"rank {rank}: a multi-card check failed")
    return line


if __name__ == "__main__":
    main()
