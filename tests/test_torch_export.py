"""The kernels as `torch.library` ops, export of the sampler, and tracing.

Each `gmtpu_torch` op passes `torch.library.opcheck` on CPU tensors (its
schema, autograd registration, fake implementation and a traced run agree
with its CPU implementation, the plain version). A tiny sampler exported
with `utils/export.py` (its attention forced onto the flash op, and a 3D
one with `GMTPU_FUSED_RESBLOCK=1` on the fused-conv op) and reloaded from
its `.pt2` file returns the in-process sampler's images to the bit, also
through `serve --export-path --oneshot` in a process that builds no
network. `trace` and `annotate` write a Chrome trace that holds the span
and the op's name.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from generativemodels_tpu_torch.recipes import serve
from generativemodels_tpu_torch.utils import annotate, load_exported, trace
from tests.torch_threads import one_torch_thread  # noqa: F401

fa = importlib.import_module("generativemodels_tpu_torch.ops.flash_attention")
fc = importlib.import_module("generativemodels_tpu_torch.ops.fused_conv")

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = Path(__file__).resolve().parent.parent
TINY = dict(size=16, channels=(16, 32), norm_groups=8, batch=2)


def _qkv(dtype, sq=64, sk=64, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, sq, d, generator=g)
    k, v = torch.randn(2, sk, d, generator=g), torch.randn(2, sk, d, generator=g)
    return tuple(t.to(dtype) for t in (q, k, v))


FWD_CASES = {
    "default": (torch.float32, False, False, True),
    "causal": (torch.float32, True, False, True),
    "bf16": (torch.bfloat16, False, False, True),
    "running_max": (torch.float32, False, False, False),
    "upcast_bf16": (torch.bfloat16, False, True, False),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_op_passes_opcheck(case):
    dtype, causal, upcast, no_max = FWD_CASES[case]
    q, k, v = (t.requires_grad_() for t in _qkv(dtype, sk=48))
    torch.library.opcheck(fa.flash_fwd, (q, k, v, 0.17, causal, upcast, no_max, not upcast))
    out, lse = fa.flash_fwd(q, k, v, 0.17, causal, upcast, no_max, not upcast)
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == q.shape[:2]


@pytest.mark.parametrize("op", ["flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused"])
@pytest.mark.parametrize("upcast", [False, True])
def test_flash_backward_ops_pass_opcheck(op, upcast):
    q, k, v = _qkv(torch.float32)
    out, lse = fa.flash_fwd(q, k, v, 0.2, False, upcast, True, not upcast)
    dout, delta = fa._backward_rows(out, torch.randn_like(out), upcast)
    qk = q if upcast else fa._prescaled(q, 0.2)
    torch.library.opcheck(getattr(fa, op), (qk, k, v, dout, lse, delta, False, upcast, True, 0.2))


def test_flash_ops_give_the_plain_backward():
    """Autograd through `flash_fwd` equals the plain backward, split and
    fused alike."""
    q, k, v = _qkv(torch.float32, sq=40, sk=72)
    dout = torch.randn_like(q)
    grads = {}
    for fused in ("0", "1"):
        os.environ["GMTPU_FLASH_FUSED_BWD"] = fused
        try:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention(*leaves, scale=0.2, causal=True).backward(dout)
            grads[fused] = [t.grad for t in leaves]
        finally:
            del os.environ["GMTPU_FLASH_FUSED_BWD"]
    out, lse = fa.flash_attention_reference(q, k, v, scale=0.2, causal=True, log2_lse=True)
    dq, dk, dv = fa.flash_attention_backward_reference(
        fa._prescaled(q, 0.2), k, v, out, lse, dout, causal=True)
    want = [fa._prescaled(dq, 0.2), dk, dv]
    for fused in ("0", "1"):
        for got, ref in zip(grads[fused], want):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_conv3d_op_passes_opcheck(channels_first, residual):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(1, 8, 6, 5, 4, generator=g).permute(0, 2, 3, 4, 1) if channels_first
         else torch.randn(1, 6, 5, 4, 8, generator=g))
    w = torch.randn(3, 3, 3, 8, 16, generator=g) * 0.1
    scale, shift = torch.randn(1, 8, generator=g), torch.randn(1, 8, generator=g)
    bias = torch.randn(16, generator=g)
    res = torch.randn(1, 6, 5, 4, 16, generator=g) if residual else None
    args = [t.requires_grad_() if t is not None else None for t in (x, w, scale, shift, bias, res)]
    torch.library.opcheck(fc.fused_conv3d, (*args, True))
    out = fc.fused_conv3d(*args, True)
    assert out.stride() == fc._empty_output(x, 16).stride()


def _sampler(solver="ddim", steps=2, **overrides):
    fn, shape = serve.build_sampler(**dict(TINY, **overrides), ddim_steps=steps, device="cpu",
                                    solver=solver)
    for m in fn.model.modules():  # 64 tokens: force the flash op's plain version
        if hasattr(m, "use_flash_attention"):
            m.use_flash_attention = True
    return fn


@pytest.mark.parametrize("solver", ["ddim", "sde-dpmsolver"])
def test_exported_sampler_equals_the_in_process_one(tmp_path, solver):
    fn = _sampler(solver)
    want = fn(5)
    path = str(tmp_path / "sampler.pt2")
    exported = serve.export_sampler(fn, path)
    assert exported.shape == (2, 1, 16, 16)
    assert exported.steps == (2 if solver == "sde-dpmsolver" else 0)
    assert "gmtpu_torch.flash_fwd" in str(exported.fn.program.graph)
    torch.testing.assert_close(exported(5), want, rtol=0, atol=0)
    # a fresh load of the file, as a serving process makes it
    torch.testing.assert_close(serve.ExportedSampler(load_exported(path))(5), want,
                               rtol=0, atol=0)


def test_exported_3d_sampler_runs_the_fused_conv_op(tmp_path, monkeypatch):
    monkeypatch.setenv("GMTPU_FUSED_RESBLOCK", "1")
    fn = _sampler("dpmsolver", spatial_dims=3, size=8, batch=1)
    want = fn(2)
    exported = serve.export_sampler(fn, str(tmp_path / "s3d.pt2"))
    graph = str(exported.fn.program.graph)
    assert "gmtpu_torch.fused_conv3d" in graph and "gmtpu_torch.flash_fwd" in graph
    torch.testing.assert_close(exported(2), want, rtol=0, atol=0)


def test_serve_export_path_oneshot_builds_no_network(tmp_path):
    fn = _sampler()
    path = str(tmp_path / "sampler.pt2")
    serve.export_sampler(fn, path)
    out = str(tmp_path / "out.npy")
    code = (
        "import sys\n"
        "from generativemodels_tpu_torch.networks.nets import diffusion_model_unet as d\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a network was built')\n"
        "d.DiffusionModelUNet.__init__ = refuse\n"
        "from generativemodels_tpu_torch.recipes import serve\n"
        "serve.main(sys.argv[1:])\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, "--export-path", path, "--oneshot", "--out", out,
         "--seed", "3", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no model build" in proc.stdout
    np.testing.assert_array_equal(np.load(out), fn(3).numpy())


def test_serve_main_exports_then_serves_the_export(tmp_path, capsys):
    path = str(tmp_path / "s.pt2")
    out = str(tmp_path / "a.npy")
    flags = ["--device", "cpu", "--size", "16", "--channels", "16", "32", "--norm-groups", "8",
             "--ddim-steps", "2", "--export-path", path, "--oneshot", "--out", out]
    serve.main(flags)
    assert os.path.exists(path) and "exported sampler" in capsys.readouterr().out
    fn, _ = serve.build_sampler(size=16, channels=(16, 32), norm_groups=8, ddim_steps=2,
                                device="cpu")
    np.testing.assert_array_equal(np.load(out), fn(0).numpy())


def test_trace_holds_the_span_and_the_op(tmp_path):
    q, k, v = _qkv(torch.float32)
    with trace(str(tmp_path)) as prof:
        with annotate("unet"):
            fa.flash_attention(q, k, v, scale=0.2)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unet" in names and "gmtpu_torch::flash_fwd" in names
    assert any(e.key == "gmtpu_torch::flash_fwd" for e in prof.key_averages())
