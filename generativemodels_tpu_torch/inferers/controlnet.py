"""ControlNet-conditioned diffusion inferers.

Counterpart of generativemodels_tpu/inferers/controlnet.py: every model
evaluation is preceded by a ControlNet forward on the same input, whose
residuals go into the UNet's residual arguments. The diffusion model
callable is wrapped, so the parents' sampling and likelihood loops run as
they are. The latent variant resizes the control image to the latent's
spatial shape by torch's `nearest` rule (source index floor(i * in /
out)), as the reference does, and not by the `nearest-exact` rule of
`latent.py`'s resampling. A VQ-VAE's `quantized` flag reaches the
autoencoder as in `LatentDiffusionInferer`, and so does a SPADE
segmentation `seg`.
"""
from __future__ import annotations

import torch

from ..networks.nets.vqvae import VQVAE
from .inferer import DiffusionInferer
from .latent import LatentDiffusionInferer


def _wrap_with_controlnet(diffusion_model, controlnet, cn_cond):
    def wrapped(x, timesteps, context=None, **kwargs):
        down_res, mid_res = controlnet(x, timesteps, controlnet_cond=cn_cond, context=context)
        return diffusion_model(
            x, timesteps, context=context, down_block_additional_residuals=down_res,
            mid_block_additional_residual=mid_res, **kwargs,
        )

    return wrapped


class ControlNetDiffusionInferer(DiffusionInferer):
    """DiffusionInferer with a ControlNet forward before every model call."""

    def __call__(
        self,
        inputs: torch.Tensor,
        diffusion_model,
        controlnet,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
        cn_cond: torch.Tensor,
        condition: torch.Tensor | None = None,
        mode: str = "crossattn",
        seg: torch.Tensor | None = None,
    ) -> torch.Tensor:
        return super().__call__(
            inputs, _wrap_with_controlnet(diffusion_model, controlnet, cn_cond), noise,
            timesteps, condition=condition, mode=mode, seg=seg,
        )

    def sample(
        self,
        input_noise: torch.Tensor,
        diffusion_model,
        controlnet,
        cn_cond: torch.Tensor,
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
        return super().sample(
            input_noise, _wrap_with_controlnet(diffusion_model, controlnet, cn_cond),
            scheduler=scheduler, save_intermediates=save_intermediates,
            intermediate_steps=intermediate_steps, conditioning=conditioning, mode=mode,
            verbose=verbose, seg=seg, generator=generator, eta=eta,
        )

    def get_likelihood(
        self,
        inputs: torch.Tensor,
        diffusion_model,
        controlnet,
        cn_cond: torch.Tensor,
        scheduler=None,
        save_intermediates: bool = False,
        conditioning: torch.Tensor | None = None,
        mode: str = "crossattn",
        original_input_range: tuple = (0, 255),
        scaled_input_range: tuple = (0, 1),
        verbose: bool = False,
        seg: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ):
        return super().get_likelihood(
            inputs, _wrap_with_controlnet(diffusion_model, controlnet, cn_cond),
            scheduler=scheduler, save_intermediates=save_intermediates,
            conditioning=conditioning, mode=mode, original_input_range=original_input_range,
            scaled_input_range=scaled_input_range, verbose=verbose, seg=seg,
            generator=generator, noise=noise,
        )


class ControlNetLatentDiffusionInferer(LatentDiffusionInferer):
    """ControlNet and latent diffusion; cn_cond is resized to the latent's shape."""

    @staticmethod
    def _fit_cn_cond(cn_cond: torch.Tensor, latent_like: torch.Tensor) -> torch.Tensor:
        """cn_cond resized to latent_like's spatial shape by torch's nearest
        rule, source index floor(i * (in / out)) in float32, as the JAX
        module computes it (the other rule, nearest-exact, picks other
        pixels when it shrinks)."""
        for axis, out_s in enumerate(latent_like.shape[2:], start=2):
            in_s = cn_cond.shape[axis]
            if in_s == out_s:
                continue
            pos = torch.arange(out_s, dtype=torch.float32) * torch.tensor(in_s / out_s)
            idx = torch.floor(pos).long().to(cn_cond.device)
            cn_cond = cn_cond.index_select(axis, idx)
        return cn_cond

    def __call__(
        self,
        inputs: torch.Tensor,
        autoencoder_model,
        diffusion_model,
        controlnet,
        noise: torch.Tensor,
        timesteps: torch.Tensor,
        cn_cond: torch.Tensor,
        condition: torch.Tensor | None = None,
        mode: str = "crossattn",
        seg: torch.Tensor | None = None,
        quantized: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cn_cond = self._fit_cn_cond(cn_cond, noise)
        return super().__call__(
            inputs, autoencoder_model, _wrap_with_controlnet(diffusion_model, controlnet, cn_cond),
            noise, timesteps, condition=condition, mode=mode, seg=seg, quantized=quantized,
            generator=generator,
        )

    def sample(
        self,
        input_noise: torch.Tensor,
        autoencoder_model,
        diffusion_model,
        controlnet,
        cn_cond: torch.Tensor,
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
        cn_cond = self._fit_cn_cond(cn_cond, input_noise)
        return super().sample(
            input_noise, autoencoder_model,
            _wrap_with_controlnet(diffusion_model, controlnet, cn_cond), scheduler=scheduler,
            save_intermediates=save_intermediates, intermediate_steps=intermediate_steps,
            conditioning=conditioning, mode=mode, verbose=verbose, seg=seg,
            generator=generator, eta=eta,
        )

    def get_likelihood(
        self,
        inputs: torch.Tensor,
        autoencoder_model,
        diffusion_model,
        controlnet,
        cn_cond: torch.Tensor,
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
        """cn_cond is fitted to the shape of the first input's latent as the
        autoencoder encodes it (before any ldm_latent_shape padding), as in
        the JAX module."""
        kwargs = {"quantized": quantized} if isinstance(autoencoder_model, VQVAE) else {}
        probe = autoencoder_model.encode_stage_2_inputs(inputs[:1], **kwargs)
        cn_cond = self._fit_cn_cond(cn_cond, probe)
        return super().get_likelihood(
            inputs, autoencoder_model,
            _wrap_with_controlnet(diffusion_model, controlnet, cn_cond), scheduler=scheduler,
            save_intermediates=save_intermediates, conditioning=conditioning, mode=mode,
            original_input_range=original_input_range, scaled_input_range=scaled_input_range,
            verbose=verbose, resample_latent_likelihoods=resample_latent_likelihoods,
            resample_interpolation_mode=resample_interpolation_mode, seg=seg,
            quantized=quantized, generator=generator, noise=noise,
        )
