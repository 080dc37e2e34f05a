"""SSIM and MS-SSIM metrics on the inputs' device.

Counterpart of generativemodels_tpu/metrics/ssim.py (SSIMMetric,
compute_ssim_and_cs with separable gaussian or uniform windows, and
MultiScaleSSIMMetric with the Wang 5-scale weights over an average-pool
pyramid), 2D and 3D. The window's depthwise VALID convolution is
`F.conv2d` / `F.conv3d` with one group a channel (JAX: `lax.conv`), in
float32.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
import torch.nn.functional as F

_CONV = {2: F.conv2d, 3: F.conv3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _ensure_tuple(v, n: int) -> tuple:
    if isinstance(v, Sequence) and not isinstance(v, str):
        return tuple(v)
    return (v,) * n


def _gaussian_kernel(
    spatial_dims: int, kernel_size: Sequence[int], kernel_sigma: Sequence[float]
) -> np.ndarray:
    """Separable gaussian kernel of shape (*kernel_size,), float32."""

    def gaussian_1d(size: int, sigma: float) -> np.ndarray:
        dist = np.arange((1 - size) / 2, (1 + size) / 2, 1, dtype=np.float32)
        gauss = np.exp(-((dist / sigma) ** 2) / 2)
        return gauss / gauss.sum()

    kernel = gaussian_1d(kernel_size[0], kernel_sigma[0])[:, None] @ gaussian_1d(
        kernel_size[1], kernel_sigma[1]
    )[None, :]
    if spatial_dims == 3:
        kz = gaussian_1d(kernel_size[2], kernel_sigma[2])
        kernel = kernel[..., None] * kz[None, None, :]
    return kernel


def _floating(x: torch.Tensor) -> torch.Tensor:
    """`x` in its own floating type (the pyramid pools in the input's type,
    as JAX's reduce_window), integers as float32."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _depthwise_valid_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID conv of (B, C, *spatial) with a (*k,) kernel."""
    c = x.shape[1]
    weight = kernel.expand((c, 1) + tuple(kernel.shape))
    return _CONV[x.ndim - 2](x, weight, groups=c)


def compute_ssim_and_cs(
    y_pred: torch.Tensor,
    y: torch.Tensor,
    spatial_dims: int,
    data_range: float = 1.0,
    kernel_type: str = "gaussian",
    kernel_size: Sequence[int] | int = 11,
    kernel_sigma: Sequence[float] | float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-image SSIM map and contrast sensitivity for (B, C, *spatial)."""
    if y.shape != y_pred.shape:
        raise ValueError(
            f"y_pred and y should have same shapes, got {tuple(y_pred.shape)} and "
            f"{tuple(y.shape)}."
        )
    kernel_size = _ensure_tuple(kernel_size, spatial_dims)
    kernel_sigma = _ensure_tuple(kernel_sigma, spatial_dims)

    y_pred = y_pred.to(torch.float32)
    y = y.to(torch.float32)

    if kernel_type == "gaussian":
        kernel = torch.from_numpy(_gaussian_kernel(spatial_dims, kernel_size, kernel_sigma))
    elif kernel_type == "uniform":
        kernel = torch.ones(kernel_size, dtype=torch.float32) / float(np.prod(kernel_size))
    else:
        raise ValueError(f"kernel_type must be 'gaussian' or 'uniform', got {kernel_type}")
    kernel = kernel.to(y.device)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _depthwise_valid_conv(y_pred, kernel)
    mu_y = _depthwise_valid_conv(y, kernel)
    mu_xx = _depthwise_valid_conv(y_pred * y_pred, kernel)
    mu_yy = _depthwise_valid_conv(y * y, kernel)
    mu_xy = _depthwise_valid_conv(y_pred * y, kernel)

    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y

    contrast_sensitivity = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x**2 + mu_y**2 + c1)) * contrast_sensitivity
    return ssim, contrast_sensitivity


class SSIMMetric:
    """Structural Similarity Index per batch element (mean over the SSIM map)."""

    def __init__(
        self,
        spatial_dims: int,
        data_range: float = 1.0,
        kernel_type: str = "gaussian",
        kernel_size: Sequence[int] | int = 11,
        kernel_sigma: Sequence[float] | float = 1.5,
        k1: float = 0.01,
        k2: float = 0.03,
        reduction: str = "mean",
        get_not_nans: bool = False,
    ) -> None:
        self.spatial_dims = spatial_dims
        self.data_range = data_range
        self.kernel_type = kernel_type
        self.kernel_size = _ensure_tuple(kernel_size, spatial_dims)
        self.kernel_sigma = _ensure_tuple(kernel_sigma, spatial_dims)
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction
        self.get_not_nans = get_not_nans

    def _reduce(self, per_batch: torch.Tensor):
        """Apply `reduction`; with get_not_nans=True NaN entries are excluded
        and `(value, not_nans_count)` is returned."""
        if self.get_not_nans:
            finite = torch.isfinite(per_batch)
            not_nans = torch.sum(finite).to(torch.float32)
            safe = torch.where(finite, per_batch, torch.zeros_like(per_batch))
            if self.reduction == "mean":
                return safe.sum() / torch.clamp(not_nans, min=1.0), not_nans
            if self.reduction == "sum":
                return safe.sum(), not_nans
            return per_batch, not_nans
        if self.reduction == "mean":
            return per_batch.mean()
        if self.reduction == "sum":
            return per_batch.sum()
        return per_batch

    def _validate(self, y_pred):
        expected = self.spatial_dims + 2
        if y_pred.ndim != expected:
            raise ValueError(
                f"y_pred should have {expected} dimensions when using "
                f"{self.spatial_dims} spatial dimensions, got {y_pred.ndim}."
            )

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self._validate(y_pred)
        ssim, _ = compute_ssim_and_cs(
            y_pred, y, self.spatial_dims, self.data_range, self.kernel_type,
            self.kernel_size, self.kernel_sigma, self.k1, self.k2,
        )
        per_batch = ssim.reshape(ssim.shape[0], -1).mean(dim=1, keepdim=True)
        return self._reduce(per_batch)


class MultiScaleSSIMMetric(SSIMMetric):
    """MS-SSIM over an avg-pool pyramid with per-scale CS weighting."""

    def __init__(
        self,
        spatial_dims: int,
        data_range: float = 1.0,
        kernel_type: str = "gaussian",
        kernel_size: Sequence[int] | int = 11,
        kernel_sigma: Sequence[float] | float = 1.5,
        k1: float = 0.01,
        k2: float = 0.03,
        weights: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        reduction: str = "mean",
        get_not_nans: bool = False,
    ) -> None:
        super().__init__(
            spatial_dims, data_range, kernel_type, kernel_size, kernel_sigma, k1, k2,
            reduction, get_not_nans,
        )
        self.weights = tuple(weights)

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        self._validate(y_pred)
        weights_div = max(1, len(self.weights) - 1) ** 2
        for i, s in enumerate(y_pred.shape[2:]):
            if s // weights_div <= self.kernel_size[i] - 1:
                raise ValueError(
                    f"For {len(self.weights)} weights and kernel size "
                    f"{self.kernel_size[i]}, the image size must be larger than "
                    f"{(self.kernel_size[i] - 1) * weights_div}."
                )

        weights = torch.tensor(self.weights, dtype=torch.float32, device=y_pred.device)
        pool = _AVG_POOL[self.spatial_dims]
        multiscale = []
        ssim = None
        for _ in range(len(self.weights)):
            ssim, cs = compute_ssim_and_cs(
                y_pred, y, self.spatial_dims, self.data_range, self.kernel_type,
                self.kernel_size, self.kernel_sigma, self.k1, self.k2,
            )
            cs_per_batch = cs.reshape(cs.shape[0], -1).mean(dim=1)
            multiscale.append(torch.clamp(cs_per_batch, min=0.0))
            y_pred = pool(_floating(y_pred), 2)
            y = pool(_floating(y), 2)

        ssim_per_batch = ssim.reshape(ssim.shape[0], -1).mean(dim=1)
        multiscale[-1] = torch.clamp(ssim_per_batch, min=0.0)
        stacked = torch.stack(multiscale)
        ms = torch.prod(stacked ** weights[:, None], dim=0)
        per_batch = ms.reshape(ms.shape[0], -1).mean(dim=1, keepdim=True)
        return self._reduce(per_batch)
