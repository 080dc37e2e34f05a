"""Latent diffusion inferer: a stage-1 autoencoder around DiffusionInferer.

Counterpart of generativemodels_tpu/inferers/latent.py: `scale_factor`,
the center pad or crop between the autoencoder's latent shape and the
diffusion model's, the `quantized` flag of VQ-VAE latents, and the
latent-space likelihood with its KL maps resampled to the image's shape.

`autoencoder_model` is any object with `encode_stage_2_inputs` and
`decode_stage_2_outputs` (as `AutoencoderKL`); a `VQVAE` gets `quantized=`
in place of a generator. The encode runs without autograd: its latent is a
constant of the diffusion model's loss, as the JAX module's stop_gradient
makes it. SPADE's `seg` is not ported yet: passing one raises
NotImplementedError.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F

from ..networks.nets.vqvae import VQVAE
from .inferer import DiffusionInferer, ModelFn

_LINEAR_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def _center_pad_or_crop(x: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """Symmetrically zero-pad or center-crop (B, C, *spatial) to a spatial
    shape; an odd difference puts the extra row after (pad) or keeps the
    first rows (crop)."""
    slices = [slice(None), slice(None)]
    pads = []
    for cur, tgt in zip(x.shape[2:], spatial_shape):
        if tgt >= cur:
            lo = (tgt - cur) // 2
            pads.append((lo, tgt - cur - lo))
            slices.append(slice(None))
        else:
            lo = (cur - tgt) // 2
            pads.append((0, 0))
            slices.append(slice(lo, lo + tgt))
    x = x[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        # F.pad lists the last axis first
        x = F.pad(x, [p for pair in reversed(pads) for p in pair])
    return x


def _resize_spatial(x: torch.Tensor, spatial_shape: Sequence[int], method: str) -> torch.Tensor:
    """`jax.image.resize` of (B, C, *spatial) to a spatial shape.

    Its "nearest" takes half-pixel centres, torch's "nearest-exact" (torch's
    "nearest" floors); its "linear" is torch's linear mode of the input's
    rank with align_corners=False, which "bilinear" and "trilinear" both
    name. The likelihood resamples the latent's KL maps up to the image,
    where JAX's antialiasing (a downsampling filter) does nothing.
    """
    if method == "nearest":
        return F.interpolate(x, size=tuple(spatial_shape), mode="nearest-exact")
    return F.interpolate(
        x, size=tuple(spatial_shape), mode=_LINEAR_MODES[x.ndim - 2], align_corners=False
    )


def _no_seg(seg) -> None:
    if seg is not None:
        raise NotImplementedError("SPADE conditioning (seg) is not ported yet")


class LatentDiffusionInferer(DiffusionInferer):
    """Wraps a stage-1 autoencoder around DiffusionInferer.

    Args:
        scheduler: diffusion scheduler for the latent space.
        scale_factor: multiplier applied to encoded latents (the LDM
            convention: 1/std of a training batch's latents).
        ldm_latent_shape, autoencoder_latent_shape: spatial shapes to pad
            latents to for the diffusion model and to crop them back to for
            the decoder, when the two disagree; both or neither.
    """

    def __init__(
        self,
        scheduler,
        scale_factor: float = 1.0,
        ldm_latent_shape: Sequence[int] | None = None,
        autoencoder_latent_shape: Sequence[int] | None = None,
    ) -> None:
        super().__init__(scheduler=scheduler)
        self.scale_factor = scale_factor
        if (ldm_latent_shape is None) ^ (autoencoder_latent_shape is None):
            raise ValueError(
                "If ldm_latent_shape is None, autoencoder_latent_shape must be None and vice versa."
            )
        self.ldm_latent_shape = ldm_latent_shape
        self.autoencoder_latent_shape = autoencoder_latent_shape

    def _encode(self, autoencoder_model, inputs, quantized: bool, generator) -> torch.Tensor:
        kwargs = {}
        if isinstance(autoencoder_model, VQVAE):
            kwargs["quantized"] = quantized
        elif generator is not None:
            kwargs["generator"] = generator
        with torch.no_grad():  # a constant, as the JAX module's stop_gradient
            latent = autoencoder_model.encode_stage_2_inputs(inputs, **kwargs)
        latent = latent * self.scale_factor
        if self.ldm_latent_shape is not None:
            latent = _center_pad_or_crop(latent, self.ldm_latent_shape)
        return latent

    def _decode(self, autoencoder_model, latent: torch.Tensor) -> torch.Tensor:
        if self.autoencoder_latent_shape is not None:
            latent = _center_pad_or_crop(latent, self.autoencoder_latent_shape)
        return autoencoder_model.decode_stage_2_outputs(latent / self.scale_factor)

    def __call__(
        self,
        inputs: torch.Tensor,
        autoencoder_model,
        diffusion_model: ModelFn,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
        condition: torch.Tensor | None = None,
        mode: str = "crossattn",
        seg: torch.Tensor | None = None,
        quantized: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Encode (sampling the latent from `generator`), then one training
        forward of the diffusion model on the latent."""
        _no_seg(seg)
        latent = self._encode(autoencoder_model, inputs, quantized, generator)
        return super().__call__(latent, diffusion_model, noise, timesteps, condition, mode)

    def sample(
        self,
        input_noise: torch.Tensor,
        autoencoder_model,
        diffusion_model: ModelFn,
        scheduler=None,
        save_intermediates: bool = False,
        intermediate_steps: int = 100,
        conditioning: torch.Tensor | None = None,
        mode: str = "crossattn",
        verbose: bool = False,
        seg: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        eta: float = 0.0,
    ):
        """The latent chain from `input_noise`, then the decode; with
        `save_intermediates`, (image, the decoded intermediates)."""
        _no_seg(seg)
        outputs = super().sample(
            input_noise, diffusion_model, scheduler=scheduler,
            save_intermediates=save_intermediates, intermediate_steps=intermediate_steps,
            conditioning=conditioning, mode=mode, verbose=verbose, generator=generator, eta=eta,
        )
        if save_intermediates:
            latent, latent_intermediates = outputs
            return self._decode(autoencoder_model, latent), [
                self._decode(autoencoder_model, li) for li in latent_intermediates
            ]
        return self._decode(autoencoder_model, outputs)

    def get_likelihood(
        self,
        inputs: torch.Tensor,
        autoencoder_model,
        diffusion_model: ModelFn,
        scheduler=None,
        save_intermediates: bool = False,
        conditioning: torch.Tensor | None = None,
        mode: str = "crossattn",
        original_input_range: tuple = (0, 255),
        scaled_input_range: tuple = (0, 1),
        verbose: bool = False,
        resample_latent_likelihoods: bool = False,
        resample_interpolation_mode: str = "nearest",
        seg: torch.Tensor | None = None,
        quantized: bool = True,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        """`DiffusionInferer.get_likelihood` of the encoded latent (its
        sample drawn from torch's default generator, as JAX draws it from
        the bound module's stream); `generator` or `noise` as there. With
        `save_intermediates` and `resample_latent_likelihoods`, each KL map
        is resampled to the input's spatial shape."""
        _no_seg(seg)
        if resample_latent_likelihoods and resample_interpolation_mode not in (
            "nearest",
            "bilinear",
            "trilinear",
        ):
            raise ValueError(
                "resample_interpolation mode should be either nearest, bilinear, or "
                f"trilinear, got {resample_interpolation_mode}"
            )
        latents = self._encode(autoencoder_model, inputs, quantized, None)
        outputs = super().get_likelihood(
            latents, diffusion_model, scheduler=scheduler,
            save_intermediates=save_intermediates, conditioning=conditioning, mode=mode,
            original_input_range=original_input_range, scaled_input_range=scaled_input_range,
            verbose=verbose, generator=generator, noise=noise,
        )
        if save_intermediates and resample_latent_likelihoods:
            total, intermediates = outputs
            return total, [
                _resize_spatial(x, inputs.shape[2:], resample_interpolation_mode)
                for x in intermediates
            ]
        return outputs
