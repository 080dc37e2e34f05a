"""Frechet Inception Distance on the inputs' device.

Counterpart of generativemodels_tpu/metrics/fid.py: FID over extracted
(N, F) feature vectors, the trace of sqrtm(sigma_x sigma_y) computed from
the symmetric eigendecomposition of sqrt(sigma_x) sigma_y sqrt(sigma_x),
which equals it for PSD covariances, in float32 (float64 where torch's
default dtype is float64, as JAX takes float64 under x64).
"""
from __future__ import annotations

import torch


class FIDMetric:
    """FID between two sets of feature vectors with shape (N, F)."""

    def __call__(self, y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return get_fid_score(y_pred, y)


def get_fid_score(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if y.ndim > 2 or y_pred.ndim > 2:
        raise ValueError("Inputs should have (number images, number of features) shape.")
    dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    y = torch.as_tensor(y).to(dtype)
    y_pred = torch.as_tensor(y_pred).to(dtype)

    mu_y_pred = torch.mean(y_pred, dim=0)
    sigma_y_pred = _cov(y_pred)
    mu_y = torch.mean(y, dim=0)
    sigma_y = _cov(y)
    return compute_frechet_distance(mu_y_pred, sigma_y_pred, mu_y, sigma_y)


def _cov(m: torch.Tensor) -> torch.Tensor:
    """Covariance with observations in rows, variables in columns."""
    m = m - torch.mean(m, dim=0, keepdim=True)
    return m.T @ m / (m.shape[0] - 1)


def _psd_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD matrix square root via eigendecomposition."""
    w, v = torch.linalg.eigh(a)
    w = torch.clamp(w, min=0.0)
    return (v * torch.sqrt(w)[None, :]) @ v.T


def _trace_sqrtm_product(sigma_x: torch.Tensor, sigma_y: torch.Tensor) -> torch.Tensor:
    """tr(sqrtm(sigma_x @ sigma_y)) for PSD sigma_x, sigma_y: the sum of the
    square roots of the (non-negative) eigenvalues of the symmetrised
    product sqrt(A) B sqrt(A)."""
    sqrt_x = _psd_sqrt(sigma_x)
    m = sqrt_x @ sigma_y @ sqrt_x
    m = (m + m.T) / 2  # clean numerical asymmetry
    w = torch.linalg.eigvalsh(m)
    return torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))


def compute_frechet_distance(
    mu_x: torch.Tensor,
    sigma_x: torch.Tensor,
    mu_y: torch.Tensor,
    sigma_y: torch.Tensor,
    epsilon: float = 1e-6,
) -> torch.Tensor:
    """Frechet distance between two multivariate normals."""
    diff = mu_x - mu_y
    tr_covmean = _trace_sqrtm_product(sigma_x, sigma_y)
    return torch.dot(diff, diff) + torch.trace(sigma_x) + torch.trace(sigma_y) - 2.0 * tr_covmean
