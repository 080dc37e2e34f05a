"""Spectral (Jukebox) loss: MSE between FFT amplitude spectra.

Counterpart of generativemodels_tpu/losses/spectral_loss.py: `torch.fft.fftn`
over the channel and spatial axes, "ortho" norm by default.
"""
from __future__ import annotations

import torch


class JukeboxLoss:
    """MSE between |FFT(input)| and |FFT(target)| over channel+spatial axes."""

    def __init__(
        self,
        spatial_dims: int,
        fft_signal_size: tuple[int, ...] | None = None,
        fft_norm: str = "ortho",
        reduction: str = "mean",
    ) -> None:
        if reduction not in ("none", "mean", "sum"):
            raise ValueError("reduction must be one of 'none', 'mean', 'sum'")
        self.spatial_dims = spatial_dims
        self.fft_signal_size = fft_signal_size
        self.fft_dim = tuple(range(1, spatial_dims + 2))
        self.fft_norm = fft_norm
        self.reduction = reduction

    def _amplitude(self, images: torch.Tensor) -> torch.Tensor:
        img_fft = torch.fft.fftn(images, s=self.fft_signal_size, dim=self.fft_dim,
                                 norm=self.fft_norm)
        return torch.sqrt(img_fft.real**2 + img_fft.imag**2)

    def __call__(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        loss = (self._amplitude(input) - self._amplitude(target)) ** 2
        if self.reduction == "mean":
            return torch.mean(loss)
        if self.reduction == "sum":
            return torch.sum(loss)
        return loss
