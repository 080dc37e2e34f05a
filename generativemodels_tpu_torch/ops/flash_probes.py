"""The two attention-forward probe kernels (kernels 6 and 7): CUDA kernels and
their plain versions.

Counterparts of the Pallas TPU kernels in benchmarks/probe_overlap.py
(`flash_var` with `_kernel`, `_kernel_q2`, `_score_probs`) and
benchmarks/probe_attn_vpu.py (`flash_var` with `_fwd_kernel_var`). Both
kernels are `csrc/flash_probes.cu`, whose header says what bounds them and
how they are laid out. `flash_overlap_reference` and `flash_vpu_reference`
are plain PyTorch code for the same functions: the CPU path, and what the
kernels are held against.

Overlap probe (max-free, exp2 domain): q is prescaled by bf16(scale *
log2(e)), s = q k^T in f32, and by variant p = bf16(exp2(min(s, 80)))
(`full`, `ilv2`, `ilv4`, `q2`), exp2(min(bf16(s), 80)) in bf16
(`bf16dom`, `ilv2_bf16`; in bf16, jnp.exp2 is exp(x * bf16(ln 2)) with the
product rounded to bf16, and so is this) or bf16(s) (`mxu_only`, garbage by
design); l is the f32 sum of the bf16 p and o = bf16((p V) / max(l,
1e-30)).
VPU probe (online max, natural exp): with `prescaled`, q = bf16(f32(q) *
scale), else s is scaled in f32; per key tile of `block_k`, m_new =
max(m, rowmax(s)) from -1e30, alpha = exp(m - m_new), and p = exp(s - m_new)
in f32 (l sums the unrounded p) or, with `bf16_p`, exp(bf16(s - m_new)) in
bf16 (l sums the bf16 p); acc = acc alpha + bf16(p) V, o = bf16(acc /
max(l, 1e-30)). p is rounded against the running max, so the result depends
on `block_k`: the kernel's key step is `BLOCK_K`.

Both functions take bf16 (BH, S, 64) tensors whose sequence lengths are
positive multiples of the kernels' tiles, on the CPU as on the card: Sq of
BLOCK_Q (2 * BLOCK_Q for q2), Sk of BLOCK_K for the VPU probe and of
OVERLAP_KEY_MULTIPLE for the overlap probe, whose kernel zero-fills a last
half tile and gives its keys p = 0. Where the JAX scripts size their grid as
`sq // BQ` and silently drop the rest, these raise. A public function takes the plain version only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .flash_attention import LN2, _prescaled
from .native import Launcher

OVERLAP_VARIANTS = ("full", "mxu_only", "ilv2", "ilv4", "q2", "bf16dom", "ilv2_bf16")
BF16_DOMAIN = ("bf16dom", "ilv2_bf16")  # clamp and exp2 on bf16 scores
VPU_VARIANTS = {  # name: (prescaled, bf16_p), as benchmarks/probe_attn_vpu.py names them
    "prescale": (True, False),
    "bf16p": (False, True),
    "both": (True, True),
}
HEAD_DIM = 64  # the probes' D, the only width the kernels are built for
BLOCK_Q = 64  # query rows a consumer warpgroup (a block has two); q2 takes Sq in 128s
BLOCK_K = 128  # keys a tile of both kernels (kernel 7's online-max step)
OVERLAP_KEY_MULTIPLE = BLOCK_K // 2  # kernel 6 masks a last half tile
NEG_INF = -1e30  # the JAX kernels' initial running max
# the plain versions hold one (BH, rows, width) f32 matrix at a time, with
# rows chosen to keep it under this many elements (512 MB)
PLAIN_ELEMENTS = 2**27


def _overlap_block_q(variant: str) -> int:
    """The multiple of Sq the overlap kernel takes: q2's two warpgroups take
    turns over the same keys, so it takes whole 128-row blocks."""
    _check_variant(variant)
    return 2 * BLOCK_Q if variant == "q2" else BLOCK_Q


def tile_multiples(variant: str) -> tuple[int, int]:
    """(Sq, Sk) multiples the kernel of `variant` (a name of OVERLAP_VARIANTS
    or VPU_VARIANTS) takes."""
    if variant in VPU_VARIANTS:
        return BLOCK_Q, BLOCK_K
    return _overlap_block_q(variant), OVERLAP_KEY_MULTIPLE


def nearest_shape(variant: str, sq: int, sk: int) -> tuple[int, int]:
    """The nearest (Sq, Sk) the kernel of `variant` takes: each rounded up to
    its multiple of tile_multiples(variant)."""
    bq, bk = tile_multiples(variant)
    return -(-sq // bq) * bq, -(-sk // bk) * bk


def _check_variant(variant: str) -> None:
    if variant not in OVERLAP_VARIANTS:
        raise ValueError(f"variant must be one of {OVERLAP_VARIANTS}, got {variant!r}")


def _row_step(bh: int, sq: int, width: int) -> int:
    return max(1, min(sq, PLAIN_ELEMENTS // max(1, bh * width)))


def flash_overlap_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    variant: str = "full",
    with_l: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the overlap probe's kernel, in chunks of query
    rows (rows are independent: no running max).

    Args:
        q: (BH, Sq, D); k, v: (BH, Sk, D); bf16.
        scale: softmax temperature (typically 1/sqrt(D)).
        variant: one of OVERLAP_VARIANTS.
        with_l: also return the f32 row sums l (BH, Sq) (`mxu_only`'s are
            near 0 on some rows, where its output divides by the floor).

    Returns:
        O (BH, Sq, D) in q's type, and l with `with_l`.
    """
    _check_variant(variant)
    qp = _prescaled(q, scale)
    kt, vf = k.float().transpose(1, 2), v.float()
    bh, sq, _ = q.shape
    step = _row_step(bh, sq, k.shape[1])
    outs, sums = [], []
    for r0 in range(0, sq, step):
        # bf16 products are exact in f32: an f32 matmul of the rounded
        # operands is the bf16-operand product with f32 accumulation
        s = torch.matmul(qp[:, r0:r0 + step].float(), kt)
        if variant == "mxu_only":
            p = s.to(torch.bfloat16)
        elif variant in BF16_DOMAIN:
            # jnp.exp2 on bf16 is exp(x * bf16(ln 2)), each step rounded to
            # bf16; torch's bf16 ops compute in f32 and round the same way
            p = torch.clamp(s.to(torch.bfloat16), max=80.0)
            p = torch.exp(p * torch.tensor(LN2, dtype=torch.bfloat16))
        else:
            p = torch.exp2(torch.clamp(s, max=80.0)).to(torch.bfloat16)
        del s
        pf = p.float()
        l = pf.sum(dim=-1, keepdim=True)
        outs.append((torch.matmul(pf, vf) / l.clamp_min(1e-30)).to(q.dtype))
        sums.append(l[..., 0])
    out = torch.cat(outs, dim=1)
    return (out, torch.cat(sums, dim=1)) if with_l else out


def flash_vpu_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    prescaled: bool,
    bf16_p: bool,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """Plain PyTorch version of the VPU probe's kernel: the online max over key
    tiles of `block_k`, step by step as the kernel, for chunks of query rows.

    Args:
        q: (BH, Sq, D); k, v: (BH, Sk, D); bf16. Sk a multiple of block_k.
        scale: softmax temperature; prescaled: fold it into q (bf16) first;
        bf16_p: p = exp(bf16(s - m)) in bf16, else exp(s - m) in f32.
        block_k: the key step; the kernel's is BLOCK_K.

    Returns:
        O (BH, Sq, D) in q's type.
    """
    if k.shape[1] % block_k:
        raise ValueError(f"Sk = {k.shape[1]} is not a multiple of block_k = {block_k}")
    if prescaled:
        q = (q.float() * scale).to(q.dtype)
    bh, sq, d = q.shape
    step = _row_step(bh, sq, max(block_k, d))
    outs = []
    for r0 in range(0, sq, step):
        qc = q[:, r0:r0 + step].float()
        rows = qc.shape[1]
        m = torch.full((bh, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, rows, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, rows, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, k.shape[1], block_k):
            s = torch.matmul(qc, k[:, k0:k0 + block_k].float().transpose(1, 2))
            if not prescaled:
                s = s * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            if bf16_p:
                p = torch.exp((s - m_new).to(torch.bfloat16))
                l = l * alpha + p.float().sum(dim=-1, keepdim=True)
            else:
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(torch.bfloat16).float(), v[:, k0:k0 + block_k].float())
            acc = acc * alpha + pv
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)).to(q.dtype))
    return torch.cat(outs, dim=1)


def _check_probe_inputs(q, k, v, block_q: int, block_k: int) -> None:
    """What both probes take, on the CPU as on the card."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the probes take bfloat16 tensors, got {name} {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be (BH, S, D), got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} must lie on q's device {q.device}, got {t.device}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if q.shape[2] != HEAD_DIM:
        raise ValueError(f"the probes take head width {HEAD_DIM}, got {q.shape[2]}")
    sq, sk = q.shape[1], k.shape[1]
    if sq <= 0 or sq % block_q or sk <= 0 or sk % block_k:
        raise ValueError(
            f"Sq = {sq} and Sk = {sk} must be positive multiples of the tiles "
            f"({block_q} query rows, {block_k} keys)"
        )


def _check_cuda_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.shape[0] > 65535:
        raise ValueError(f"BH = {q.shape[0]} exceeds the grid's 65535")


class FlashProbeOverlapKernel(Launcher):
    """Launcher of the overlap entry point of `csrc/flash_probes.cu` (replaces
    benchmarks/probe_overlap.py::_kernel and _kernel_q2)."""

    source = "flash_probes.cu"
    symbol = "gm_flash_probe_overlap"
    argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4

    def __call__(self, q, k, v, *, scale: float, variant: str = "full") -> torch.Tensor:
        """Prescale q (outside the kernel, as the JAX wrapper does) and launch
        on the current stream; returns what the reference returns."""
        _check_cuda_inputs(q, k, v)
        _check_probe_inputs(q, k, v, _overlap_block_q(variant), OVERLAP_KEY_MULTIPLE)
        qp = _prescaled(q, scale)
        o = torch.empty_like(q)
        self._launch(
            q.device, qp.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], OVERLAP_VARIANTS.index(variant),
        )
        return o


class FlashProbeVpuKernel(Launcher):
    """Launcher of the VPU entry point of `csrc/flash_probes.cu` (replaces
    benchmarks/probe_attn_vpu.py::_fwd_kernel_var)."""

    source = "flash_probes.cu"
    symbol = "gm_flash_probe_vpu"
    argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_float,)

    def __call__(self, q, k, v, *, scale: float, prescaled: bool, bf16_p: bool) -> torch.Tensor:
        """Launch on the current stream (q prescaled first with `prescaled`);
        returns what the reference returns with block_k = BLOCK_K."""
        _check_cuda_inputs(q, k, v)
        _check_probe_inputs(q, k, v, BLOCK_Q, BLOCK_K)
        if prescaled:
            q = (q.float() * scale).to(q.dtype)
        o = torch.empty_like(q)
        self._launch(
            q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], int(not prescaled), int(bf16_p), scale,
        )
        return o


FLASH_PROBE_OVERLAP = FlashProbeOverlapKernel()
FLASH_PROBE_VPU = FlashProbeVpuKernel()


def flash_overlap(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, variant: str = "full"
) -> torch.Tensor:
    """The overlap probe's forward: kernel 6 on CUDA tensors, the plain version
    on CPU tensors. Returns (BH, Sq, D) bf16."""
    _check_probe_inputs(q, k, v, _overlap_block_q(variant), OVERLAP_KEY_MULTIPLE)
    if q.device.type == "cpu":
        return flash_overlap_reference(q, k, v, scale=scale, variant=variant)
    return FLASH_PROBE_OVERLAP(q, k, v, scale=scale, variant=variant)


def flash_vpu(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    prescaled: bool,
    bf16_p: bool,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """The VPU probe's forward: kernel 7 on CUDA tensors (key step
    BLOCK_K only), the plain version with key step `block_k` on CPU
    tensors. Returns (BH, Sq, D) bf16."""
    _check_probe_inputs(q, k, v, BLOCK_Q, block_k)
    if q.device.type == "cpu":
        return flash_vpu_reference(
            q, k, v, scale=scale, prescaled=prescaled, bf16_p=bf16_p, block_k=block_k
        )
    if block_k != BLOCK_K:
        raise ValueError(f"the kernel's key step is {BLOCK_K}, got block_k = {block_k}")
    return FLASH_PROBE_VPU(q, k, v, scale=scale, prescaled=prescaled, bf16_p=bf16_p)


def relative_error(
    out: torch.Tensor, plain: torch.Tensor, l: torch.Tensor | None = None
) -> tuple[float, int]:
    """How far `out` is from `plain`, with the number of rows held.

    Without `l`: max|out - plain| / max|plain| over every row. With the plain
    version's row sums `l` (for `mxu_only`, whose l comes near 0 on some rows,
    where the output divides by the 1e-30 floor and summation order is
    amplified without bound): only the rows with |l| >= 1, each against its
    own max|plain|.
    """
    diff = (out.float() - plain.float()).abs()
    ref = plain.float().abs()
    if l is None:
        return (diff.max() / ref.max()).item(), plain.shape[0] * plain.shape[1]
    held = l.abs() >= 1.0
    per_row = diff.amax(dim=-1) / ref.amax(dim=-1).clamp_min(1e-30)
    rows = int(held.sum().item())
    return (per_row[held].max().item() if rows else 0.0), rows
