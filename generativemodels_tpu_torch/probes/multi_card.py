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
   GroupNorms E[x^2] - E[x]^2, sums in another order; the H100 reads 4e-7).
   bf16: within twice the uncut bf16 step's own distance from the uncut f32
   step.
3. Sequence-parallel attention at the 3D shape, (2, 32768, 32768, 64) bf16
   as B = 1 with two heads of 64, on {"space": N}: the allgather's rows
   and dq equal to the unsharded kernels' to the bit, its dk, dv (summed by
   the reduce-scatter) within 2e-2 of their largest value, and the ring's
   rows within 2e-2 of the largest |O| (bf16: a few ulps there, the chunks'
   O rounded before the merge); 1e-5 in f32.

Times: a step on the host clock after a synchronize (the mean of steps 2-4
of each run), an attention call on the host clock between barriers. Rank 0
prints one JSON line, and writes it to `--out`. Rehearse on the CPU with
gloo: `torchrun --nproc_per_node=4 -m generativemodels_tpu_torch.probes.multi_card
--device cpu --size 16 --channels 16 32 --head-channels 16 --norm-groups 8
--seq 256`. `--backend gloo --device cuda:0` puts every rank on one card.
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
RING_BF16_TOL = 2e-2  # of the largest |O|
CHECKS = ("data_parallel", "cut_data_space", "cut_space", "attention")


def build_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--channels", type=int, nargs="+", default=[32, 64, 128])
    parser.add_argument("--head-channels", type=int, default=64)
    parser.add_argument("--norm-groups", type=int, default=32)
    parser.add_argument("--seq", type=int, default=32768)
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
    grad = torch.cat([p.grad.reshape(-1).float() for p in net.parameters()]).clone()
    seconds = []
    for _ in range(TIMED_STEPS):
        sync(device)
        t0 = time.perf_counter()
        state, _ = step(state, images, g)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    out = dict(loss=float(loss), grad=grad, step_ms=1e3 * sum(seconds[1:]) / (TIMED_STEPS - 1))
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
