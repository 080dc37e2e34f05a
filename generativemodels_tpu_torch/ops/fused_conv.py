"""Fused GroupNorm-affine + SiLU -> 3x3x3 conv -> bias [+ residual] (kernel 5).

Counterpart of generativemodels_tpu/ops/fused_conv.py. The Pallas TPU kernel
`_kernel` becomes `csrc/fused_conv.cu`, written for Hopper; its header says
what bounds it and how it is laid out.
`fused_norm_silu_conv3d_reference` is plain PyTorch code for the same
function (the counterpart of JAX's `_xla_equivalent`): the CPU path, and
what the kernel is held against. `fold_groupnorm_affine` stays plain
PyTorch, as JAX computes it outside its kernel.

`fused_norm_silu_conv3d` keeps JAX's layout: x channels-last (B, D, H, W,
Cin), the kernel (3, 3, 3, Cin, Cout). The CUDA kernel takes x, the
residual and the output through strides, so x may also be a channels-first
(B, C, D, H, W) tensor seen through `permute(0, 2, 3, 4, 1)`; the output
then has that layout too. That is how the UNet's ResnetBlock calls it
without a layout copy.

The kernel is the `torch.library` custom op `gmtpu_torch::fused_conv3d`,
so `torch.export` records it in a graph and `torch.profiler` names it: a
fake (shape and layout only) implementation, its CUDA implementation (the
launcher, which counts its launches) and a CPU implementation (the plain
version, its result laid out as the kernel lays it out). Its registered
gradient recomputes through autograd of the plain version, as JAX's
`_fused_bwd` recomputes through XLA. The op takes the plain version only
for tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .native import Launcher

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernel's tile, as csrc/fused_conv.cu builds it: output channels a
# block (BN), and the output depth planes a block (R) it is built for, longest
# first. A block keeps R accumulator tiles of 128 voxels x BN channels in
# registers (16 * R registers a thread); two blocks share an SM.
CONV_BN = 32
CONV_RUNS = (4, 2, 1)
CONV_ROWS, CONV_COLS = 4, 32  # output voxels of a block in one plane: rows x columns
CONV_CHUNK = 16  # input channels a chunk (the kernel reads Cin padded to a multiple)
H100_SMS = 132


def conv_tiles(b: int, d: int, h: int, w: int, cout: int,
               sms: int = H100_SMS) -> tuple[int, int, tuple[int, int, int]]:
    """(BN, R, grid) of the bf16 kernel for output (b, d, h, w, cout): the
    one place the tile is chosen, handed to the kernel as it is.

    BN is `CONV_BN` (a wider tile keeps one block on an SM and was no
    faster on the H100). R is the longest run of `CONV_RUNS` whose grid (h
    tiles * w tiles, B * depth runs, Cout tiles) still fills two waves of
    `sms` blocks, else 1: a block normalises each input plane once for its
    R output planes ((R + 2) / R prologues an output plane), but a long run
    leaves SMs idle on a small volume.
    """
    spatial = -(-h // CONV_ROWS) * -(-w // CONV_COLS)
    for r in CONV_RUNS:
        grid = (spatial, b * -(-d // r), -(-cout // CONV_BN))
        if r == 1 or grid[0] * grid[1] * grid[2] >= 2 * sms:
            return CONV_BN, r, grid
    raise AssertionError("CONV_RUNS ends with R = 1")


def fold_groupnorm_affine(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
    temb: torch.Tensor | None = None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm statistics (and an optional pre-norm channel bias) into
    a per-(batch, channel) affine: normalize(x + temb) == x * scale + shift.

    x: (B, *spatial, C) channels-last (any strides); temb: (B, C), added to
    x before the statistics. Returns f32 (B, C) scale and shift. Per-channel
    moments are taken in f32 and the group variance is E[x^2] - E[x]^2, as
    the JAX function computes them. With `group` (the process group of the
    ranks that hold the other slabs of x, under a spatial cut) the moments
    are those of the whole volume (`parallel.collectives.global_moments`).
    """
    b, c = x.shape[0], x.shape[-1]
    red = tuple(range(1, x.ndim - 1))
    if group is None:
        mean_c = torch.mean(x, dim=red, dtype=torch.float32)  # (B, C)
        msq_c = torch.mean(torch.square(x.float()), dim=red)
    else:
        from ..parallel.collectives import global_moments

        mean_c, msq_c = global_moments(x.float(), red, group)
    if temb is not None:
        t = temb.float()
        msq_c = msq_c + 2.0 * t * mean_c + torch.square(t)
        mean_c = mean_c + t
    g = num_groups
    mean_g = mean_c.reshape(b, g, c // g).mean(dim=-1)  # (B, G)
    msq_g = msq_c.reshape(b, g, c // g).mean(dim=-1)
    var_g = msq_g - torch.square(mean_g)
    rstd_g = torch.rsqrt(var_g + eps)
    rstd_c = torch.repeat_interleave(rstd_g, c // g, dim=-1)  # (B, C)
    mu_c = torch.repeat_interleave(mean_g, c // g, dim=-1)
    scale = gamma.float()[None] * rstd_c
    shift = beta.float()[None] - mu_c * scale
    if temb is not None:
        # the kernel normalises the raw x: the temb offset folds into the shift
        shift = shift + temb.float() * scale
    return scale, shift


def fused_norm_silu_conv3d_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    bias: torch.Tensor,
    residual: torch.Tensor | None = None,
    apply_act: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, as JAX's `_xla_equivalent`.

    The activation is computed in f32 and cast to x's type, as is the
    kernel w; the convolution of those values runs in f32 (bf16 products
    are exact in f32), and its result, the bias and the residual are added
    in f32 and cast once to x's type, as the kernel does. (JAX's
    `_xla_equivalent` rounds the convolution's result to x's type before
    the bias; in f32 the two are the same.) Layouts as
    `fused_norm_silu_conv3d`.
    """
    xf = x.float()
    if apply_act:
        xf = F.silu(xf * scale[:, None, None, None, :] + shift[:, None, None, None, :])
    a = xf.to(x.dtype).float()
    k = w.to(x.dtype).float()
    # NDHWC -> NCDHW for the convolution, DHWIO -> OIDHW for the kernel
    y = F.conv3d(a.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2), padding=1)
    y = y.permute(0, 2, 3, 4, 1) + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


class FusedConvKernel(Launcher):
    """Launcher of `csrc/fused_conv.cu` (replaces `ops/fused_conv.py::_kernel`).

    Takes w (3, 3, 3, Cin, Cout) f32 or bf16 with any strides, scale, shift
    (B, Cin) and bias (Cout) f32 contiguous. It makes the one copy of w that
    the kernel reads, contiguous and in x's type (for bf16 transposed and
    padded to whole tiles), and hands the bf16 kernel its tile, depth run
    and grid from `conv_tiles`.
    """

    source = "fused_conv.cu"
    symbol = "gm_fused_conv3d"
    argtypes = (
        (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (ctypes.POINTER(ctypes.c_longlong),)
        + (ctypes.c_int,) * 5
    )

    def __call__(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        scale: torch.Tensor,
        shift: torch.Tensor,
        bias: torch.Tensor,
        residual: torch.Tensor | None = None,
        apply_act: bool = True,
    ) -> torch.Tensor:
        """Launch on the current stream; returns what the reference returns,
        in x's memory layout (channels-last, or channels-first seen as NDHWC)."""
        _check_kernel_inputs(x, w, scale, shift, bias, residual)
        b, d, h, wd, cin = x.shape
        cout = w.shape[-1]
        # the f32 kernel reads w (3, 3, 3, Cin, Cout), the bf16 tensor-core
        # kernel w transposed and padded with zeros to whole tiles, (3, 3, 3,
        # Cout_p, Cin_p); both contiguous in x's type. `to` copies into the
        # contiguous layout when the type changes (then `contiguous` has
        # nothing to do), else `contiguous` copies if the layout needs it:
        # one copy, or the pad's.
        bn = rd = 0
        if x.dtype == torch.bfloat16:
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            bn, rd, _ = conv_tiles(b, d, h, wd, cout, sms)
            w = w.transpose(3, 4)
            pad_cin, pad_cout = -cin % CONV_CHUNK, -cout % bn
            if pad_cin or pad_cout:
                w = F.pad(w.to(x.dtype), (0, pad_cin, 0, pad_cout))
        w = w.to(x.dtype, memory_format=torch.contiguous_format).contiguous()
        if _channels_first(x):
            out = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=x.device)
            out = out.permute(0, 2, 3, 4, 1)
        else:
            out = torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=x.device)
        if out.numel() == 0:
            return out
        res_strides = residual.stride() if residual is not None else (0,) * 5
        strides = (ctypes.c_longlong * 15)(*x.stride(), *res_strides, *out.stride())
        self._launch(
            x.device, x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            bias.data_ptr(), residual.data_ptr() if residual is not None else None,
            out.data_ptr(), b, d, h, wd, cin, cout, strides, _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[residual.dtype] if residual is not None else 0, int(apply_act),
            bn, rd,
        )
        return out


def _channels_first(x: torch.Tensor) -> bool:
    """x is a (B, C, D, H, W) contiguous tensor seen through permute(0, 2, 3, 4, 1)."""
    return not x.is_contiguous() and x.permute(0, 4, 1, 2, 3).is_contiguous()


def _check_kernel_inputs(x, w, scale, shift, bias, residual) -> None:
    if not x.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 5:
        raise ValueError(f"x must be (B, D, H, W, Cin), got shape {tuple(x.shape)}")
    if not (x.is_contiguous() or _channels_first(x)):
        raise ValueError("x must be contiguous channels-last or a permuted channels-first tensor")
    b, d, h, wd, cin = x.shape
    if b * d > 65535:
        raise ValueError(f"B * D = {b * d} exceeds the kernel's grid (65535)")
    cout = w.shape[-1]
    if (w.device != x.device or tuple(w.shape) != (3, 3, 3, cin, cout)
            or w.dtype not in _DTYPE_CODES):
        raise ValueError(
            f"w must be {(3, 3, 3, cin, cout)} float32 or bfloat16 on x's device, got "
            f"{tuple(w.shape)} {w.dtype} {w.device}"
        )
    checks = (
        ("scale", scale, (b, cin), torch.float32),
        ("shift", shift, (b, cin), torch.float32),
        ("bias", bias, (cout,), torch.float32),
    )
    for name, t, shape, dtype in checks:
        if t.device != x.device or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype} on x's device, got {tuple(t.shape)} "
                f"{t.dtype} {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if residual is not None:
        if residual.device != x.device or tuple(residual.shape) != (b, d, h, wd, cout):
            raise ValueError(
                f"residual must be {(b, d, h, wd, cout)} on x's device, got "
                f"{tuple(residual.shape)} {residual.device}"
            )
        if residual.dtype not in _DTYPE_CODES:
            raise ValueError(f"residual must be float32 or bfloat16, got {residual.dtype}")


FUSED_CONV = FusedConvKernel()


def _empty_output(x: torch.Tensor, cout: int) -> torch.Tensor:
    """The kernel's output for x: channels-last, or channels-first seen as
    NDHWC when x is."""
    b, d, h, wd, _ = x.shape
    if _channels_first(x):
        out = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=x.device)
        return out.permute(0, 2, 3, 4, 1)
    return torch.empty((b, d, h, wd, cout), dtype=x.dtype, device=x.device)


@torch.library.custom_op(
    "gmtpu_torch::fused_conv3d", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, Tensor scale, Tensor shift, Tensor bias, Tensor? residual, "
           "bool apply_act) -> Tensor",
)
def fused_conv3d(x, w, scale, shift, bias, residual, apply_act):
    """Kernel 5 (the CPU implementation: the plain version, laid out as the
    kernel lays out its output)."""
    out = _empty_output(x, w.shape[-1])
    return out.copy_(
        fused_norm_silu_conv3d_reference(x, w, scale, shift, bias, residual, apply_act)
    )


@fused_conv3d.register_kernel("cuda")
def _fused_conv3d_cuda(x, w, scale, shift, bias, residual, apply_act):
    return FUSED_CONV(x, w, scale, shift, bias, residual, apply_act)


@fused_conv3d.register_fake
def _fused_conv3d_fake(x, w, scale, shift, bias, residual, apply_act):
    return _empty_output(x, w.shape[-1])


def _fused_conv3d_setup(ctx, inputs, output):
    *tensors, apply_act = inputs
    ctx.save_for_backward(*tensors)
    ctx.apply_act = apply_act


def _fused_conv3d_backward(ctx, dout):
    """Autograd of the plain version, as JAX's `_fused_bwd`."""
    x, w, scale, shift, bias, residual = ctx.saved_tensors
    inputs = [t.detach().requires_grad_(need) if t is not None else None
              for t, need in zip((x, w, scale, shift, bias, residual), ctx.needs_input_grad)]
    with torch.enable_grad():
        out = fused_norm_silu_conv3d_reference(*inputs, ctx.apply_act)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout)) if wanted else iter(())
    return (*(next(grads) if t is not None and t.requires_grad else None for t in inputs),
            None)


fused_conv3d.register_autograd(_fused_conv3d_backward, setup_context=_fused_conv3d_setup)


def fused_norm_silu_conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    shift: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    *,
    apply_act: bool = True,
) -> torch.Tensor:
    """conv3x3x3(silu(x * scale + shift)) [+ bias] [+ residual], one pass.

    Args:
        x: (B, D, H, W, Cin) channels-last input (or a channels-first tensor
            seen through permute(0, 2, 3, 4, 1)).
        w: (3, 3, 3, Cin, Cout) kernel (stride 1, padding 1).
        scale, shift: (B, Cin) folded GroupNorm affine
            (`fold_groupnorm_affine`); ignored when `apply_act=False`.
        bias: (Cout,) conv bias (zeros if None).
        residual: optional (B, D, H, W, Cout) tensor added to the output.
        apply_act: False skips the normalise + SiLU prologue (plain conv).

    Returns:
        (B, D, H, W, Cout) in x's type.
    """
    kd, kh, kw, wc_in, cout = w.shape
    if (kd, kh, kw) != (3, 3, 3) or wc_in != x.shape[-1]:
        raise ValueError(f"expected (3,3,3,{x.shape[-1]},*) kernel, got {tuple(w.shape)}")
    if x.device.type != "cpu" and not x.is_cuda:
        raise ValueError(f"fused_norm_silu_conv3d runs on CPU or CUDA tensors, not {x.device}")
    if bias is None:
        bias = torch.zeros((cout,), dtype=torch.float32, device=x.device)
    # the op takes the affine and the bias f32 contiguous; the launcher casts
    # and lays out the kernel w itself
    return fused_conv3d(x, w, scale.float().contiguous(), shift.float().contiguous(),
                        bias.float().contiguous(), residual, apply_act)
