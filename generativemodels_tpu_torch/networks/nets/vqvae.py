"""VQ-VAE with an EMA codebook, channels-first.

Counterpart of generativemodels_tpu/networks/nets/vqvae.py:
`VQVAEResidualUnit`, `VQVAEEncoder`, `VQVAEDecoder` and `VQVAE`, 2D and 3D,
with the parametrised down- and upsampling tuples (stride, kernel,
dilation, padding[, output_padding]) and the stage-2 API. The encoder and
decoder keep their layers in one `blocks` list in the reference's order,
so the state-dict keys are the reference torch keys and
networks/convert.py maps JAX parameters onto them. The 3D convolutions are
plain `conv3d` / `conv_transpose3d`; the JAX package's depth-decomposed 3D
lowering is a TPU lowering.

`forward` and `quantize` update the codebook in training mode (the JAX
module's `train=True`); `index_quantize`, `decode_samples` and the
stage-2 pair never do, as in the JAX module. Dropout follows the module's
mode. `dtype` casts the input of each of encode, quantize and decode and
returns float32, as the JAX module's `_to_cl` / `_from_cl`.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks.convolutions import ConvND, ConvTransposeND
from ..layers.vector_quantizer import EMAQuantizer, VectorQuantizer
from .diffusion_model_unet import _run_block, ensure_tuple_rep

__all__ = ["VQVAE", "VQVAEEncoder", "VQVAEDecoder", "VQVAEResidualUnit"]

_ACTS = {
    "RELU": F.relu,
    "LEAKYRELU": lambda x: F.leaky_relu(x, 0.01),
    "PRELU": F.relu,  # parameter-free, as the JAX module approximates it
    "TANH": torch.tanh,
    "SIGMOID": torch.sigmoid,
    "SILU": F.silu,
}


def _act_fn(act):
    if act is None:
        return lambda x: x
    name = act[0] if isinstance(act, (tuple, list)) else act
    fn = _ACTS.get(str(name).upper())
    if fn is None:
        raise ValueError(f"Unsupported activation: {act}")
    return fn


def _same_padding(kernel: int, dilation: int) -> int:
    return ((kernel - 1) * dilation) // 2


class _ConvDropAct(ConvND):
    """A conv, then dropout (unless `dropout` is None) and the activation."""

    def __init__(self, *args, dropout: float | None, act, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.drop = nn.Dropout(dropout) if dropout is not None else nn.Identity()
        self.act = _act_fn(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.drop(super().forward(x)))


class _ConvTransposeDropAct(ConvTransposeND):
    """A transposed conv, then dropout and the activation unless `last`."""

    def __init__(self, *args, dropout: float, act, last: bool, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.last = last
        self.drop = nn.Dropout(dropout)
        self.act = _act_fn(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        return x if self.last else self.act(self.drop(x))


class VQVAEResidualUnit(nn.Module):
    """relu(x + conv2(act(drop(conv1(x)))))."""

    def __init__(
        self,
        spatial_dims: int,
        num_channels: int,
        num_res_channels: int,
        act="RELU",
        dropout: float = 0.0,
        bias: bool = True,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        pad = _same_padding(3, 1)
        self.conv1 = _ConvDropAct(
            spatial_dims, num_channels, num_res_channels, 3, padding=pad, bias=bias,
            dtype=dtype, dropout=dropout, act=act,
        )
        self.conv2 = ConvND(
            spatial_dims, num_res_channels, num_channels, 3, padding=pad, bias=bias, dtype=dtype
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.conv2(self.conv1(x)))


class VQVAEEncoder(nn.Module):
    """`blocks`: per level a strided conv (dropout from level 1 on, then the
    activation) and `num_res_layers` residual units; then a 3x3 conv to
    `out_channels`."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        num_channels: Sequence[int],
        num_res_layers: int,
        num_res_channels: Sequence[int],
        downsample_parameters: Sequence[Sequence[int]],
        dropout: float,
        act,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        blocks: list[nn.Module] = []
        c_in = in_channels
        for i, c in enumerate(num_channels):
            stride, kernel, dilation, padding = downsample_parameters[i]
            blocks.append(_ConvDropAct(
                spatial_dims, c_in, c, kernel, strides=stride, dilation=dilation,
                padding=padding, dtype=dtype, dropout=dropout if i > 0 else None, act=act,
            ))
            blocks += [
                VQVAEResidualUnit(spatial_dims, c, num_res_channels[i], act, dropout, dtype=dtype)
                for _ in range(num_res_layers)
            ]
            c_in = c
        blocks.append(ConvND(spatial_dims, c_in, out_channels, 3, padding=1, dtype=dtype))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class VQVAEDecoder(nn.Module):
    """`blocks`: a 3x3 conv from `in_channels`; then per level, deepest
    first, `num_res_layers` residual units and a transposed conv (dropout
    and the activation after all but the last); then `output_act`."""

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        num_channels: Sequence[int],
        num_res_layers: int,
        num_res_channels: Sequence[int],
        upsample_parameters: Sequence[Sequence[int]],
        dropout: float,
        act,
        output_act,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        channels = list(reversed(tuple(num_channels)))
        res_channels = list(reversed(tuple(num_res_channels)))
        blocks: list[nn.Module] = [
            ConvND(spatial_dims, in_channels, channels[0], 3, padding=1, dtype=dtype)
        ]
        n = len(channels)
        for i in range(n):
            blocks += [
                VQVAEResidualUnit(spatial_dims, channels[i], res_channels[i], act, dropout,
                                  dtype=dtype)
                for _ in range(num_res_layers)
            ]
            stride, kernel, dilation, padding, output_padding = upsample_parameters[i]
            last = i == n - 1
            blocks.append(_ConvTransposeDropAct(
                spatial_dims, channels[i], out_channels if last else channels[i + 1], kernel,
                strides=stride, padding=padding, output_padding=output_padding,
                dilation=dilation, dtype=dtype, dropout=dropout, act=act, last=last,
            ))
        self.blocks = nn.ModuleList(blocks)
        self.output_act = _act_fn(output_act) if output_act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.output_act(x) if self.output_act is not None else x


class VQVAE(nn.Module):
    """Vector-quantised VAE over (B, C, *spatial).

    `forward` returns (reconstruction, quantization loss). Arguments mirror
    the JAX module's; `use_checkpointing` recomputes the encoder and the
    decoder in the backward; `ddp_sync` and `axis_name` go to the
    EMAQuantizer (its codebook statistics over a mesh axis).
    """

    def __init__(
        self,
        spatial_dims: int,
        in_channels: int,
        out_channels: int,
        num_channels: Sequence[int] | int = (96, 96, 192),
        num_res_layers: int = 3,
        num_res_channels: Sequence[int] | int = (96, 96, 192),
        downsample_parameters: Sequence = ((2, 4, 1, 1), (2, 4, 1, 1), (2, 4, 1, 1)),
        upsample_parameters: Sequence = ((2, 4, 1, 1, 0), (2, 4, 1, 1, 0), (2, 4, 1, 1, 0)),
        num_embeddings: int = 32,
        embedding_dim: int = 64,
        embedding_init: str = "normal",
        commitment_cost: float = 0.25,
        decay: float = 0.5,
        epsilon: float = 1e-5,
        dropout: float = 0.0,
        act="RELU",
        output_act=None,
        ddp_sync: bool = True,
        axis_name: str | None = None,
        use_checkpointing: bool = False,
        dtype: torch.dtype | None = None,
    ) -> None:
        super().__init__()
        num_channels = (num_channels,) if isinstance(num_channels, int) else tuple(num_channels)
        num_res_channels = ensure_tuple_rep(num_res_channels, len(num_channels))
        down, up = downsample_parameters, upsample_parameters
        if all(isinstance(v, int) for v in down):
            down = (tuple(down),) * len(num_channels)
        if all(isinstance(v, int) for v in up):
            up = (tuple(up),) * len(num_channels)
        if any(len(p) != 4 for p in down):
            raise ValueError("`downsample_parameters` should be a tuple of tuples with 4 integers.")
        if any(len(p) != 5 for p in up):
            raise ValueError("`upsample_parameters` should be a tuple of tuples with 5 integers.")
        if len(down) != len(num_channels) or len(up) != len(num_channels):
            raise ValueError(
                "down/upsample_parameters should have the same length as num_channels."
            )
        self.dtype = dtype
        self.use_checkpointing = use_checkpointing
        self.num_embeddings = num_embeddings
        common = dict(
            spatial_dims=spatial_dims, num_channels=num_channels, num_res_layers=num_res_layers,
            num_res_channels=num_res_channels, dropout=dropout, act=act, dtype=dtype,
        )
        self.encoder = VQVAEEncoder(
            in_channels=in_channels, out_channels=embedding_dim, downsample_parameters=down,
            **common,
        )
        self.decoder = VQVAEDecoder(
            in_channels=embedding_dim, out_channels=out_channels, upsample_parameters=up,
            output_act=output_act, **common,
        )
        self.quantizer = VectorQuantizer(EMAQuantizer(
            spatial_dims=spatial_dims, num_embeddings=num_embeddings,
            embedding_dim=embedding_dim, commitment_cost=commitment_cost, decay=decay,
            epsilon=epsilon, embedding_init=embedding_init, ddp_sync=ddp_sync,
            axis_name=axis_name,
        ))

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) if self.dtype is not None else x

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """Image -> continuous latent (B, embedding_dim, *latent_spatial)."""
        return _run_block(self.use_checkpointing, self.encoder, self._in(images)).float()

    def _quantize(self, encodings: torch.Tensor, train: bool) -> tuple[torch.Tensor, torch.Tensor]:
        loss, quantized = self.quantizer(self._in(encodings), train=train)
        return quantized.float(), loss

    def quantize(self, encodings: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Continuous latent -> (quantized latent, quantization loss); the
        codebook moves in training mode."""
        return self._quantize(encodings, self.training)

    def decode(self, quantizations: torch.Tensor) -> torch.Tensor:
        return _run_block(self.use_checkpointing, self.decoder, self._in(quantizations)).float()

    def index_quantize(self, images: torch.Tensor) -> torch.Tensor:
        """Image -> codebook indices (B, *latent_spatial)."""
        return self.quantizer.quantize(self._in(self.encode(images)))

    def decode_samples(self, embedding_indices: torch.Tensor) -> torch.Tensor:
        """Codebook indices -> decoded image."""
        return self.decoder(self._in(self.quantizer.embed(embedding_indices))).float()

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        quantizations, quantization_losses = self.quantize(self.encode(images))
        return self.decode(quantizations), quantization_losses

    def encode_stage_2_inputs(self, x: torch.Tensor, quantized: bool = True) -> torch.Tensor:
        z = self.encode(x)
        return self._quantize(z, train=False)[0] if quantized else z

    def decode_stage_2_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(self._quantize(z, train=False)[0])
