"""The port's metrics (FID, MMD, SSIM and MS-SSIM, 2D and 3D) against the JAX
package's on the same seeded numpy inputs.

Tolerances: FID at rtol 1e-4 on (64, 32) features (full-rank covariances:
f32 eigendecompositions by two LAPACK builds agree to ~1e-6 of the trace);
MMD at rtol 1e-5 (three f32 matrix products); the SSIM and contrast maps
at atol 1e-5 in 2D and 5e-5 in 3D (the window sums of 121 or 1331 terms in
another order, then the variances E[x^2] - E[x]^2 cancel about two digits
of them), SSIM at atol 1e-6 (the
mean of the map) and MS-SSIM at 1e-5 (a product of up to five powers).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativemodels_tpu import metrics as jax_metrics
from generativemodels_tpu_torch import metrics
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(shape, seed=0, noise=0.2):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape).astype(np.float32), 0, 1)
    return a, b.astype(np.float32)


def _both(fn_jax, fn_port, *arrays):
    want = fn_jax(*(jnp.asarray(a) for a in arrays))
    got = fn_port(*(torch.from_numpy(a) for a in arrays))
    return want, got


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_fid_matches_jax(shift):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    y = (rng.standard_normal((64, 32)) @ rng.standard_normal((32, 32)) * 0.3 + shift).astype(
        np.float32)
    want, got = _both(jax_metrics.FIDMetric(), metrics.FIDMetric(), x, y)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    want, got = _both(jax_metrics.get_fid_score, metrics.get_fid_score, x, y)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_frechet_distance_of_given_moments_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 16)).astype(np.float32)
    sx, sy = a @ a.T / 16, b @ b.T / 16
    mx, my = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    want, got = _both(jax_metrics.compute_frechet_distance, metrics.compute_frechet_distance,
                      mx, sx, my, sy)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_fid_rejects_images():
    with pytest.raises(ValueError, match="number of features"):
        metrics.FIDMetric()(torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))


@pytest.mark.parametrize("shape", [(4, 1, 16, 16), (3, 2, 8, 8, 8)])
def test_mmd_matches_jax(shape):
    y, y_pred = _pair(shape, seed=3)
    want, got = _both(jax_metrics.MMDMetric(), metrics.MMDMetric(), y, y_pred)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="shapes dont match"):
        metrics.MMDMetric(y_transform=lambda t: t[:, :, :2])(torch.from_numpy(y),
                                                            torch.from_numpy(y_pred))


@pytest.mark.parametrize("spatial_dims,kernel_type", [(2, "gaussian"), (2, "uniform"),
                                                      (3, "gaussian")])
def test_ssim_map_and_cs_match_jax(spatial_dims, kernel_type):
    shape = (2, 2) + (24,) * spatial_dims
    a, b = _pair(shape, seed=4)
    kwargs = dict(spatial_dims=spatial_dims, data_range=1.0, kernel_type=kernel_type,
                  kernel_size=7 if kernel_type == "uniform" else 11)
    want = jax_metrics.compute_ssim_and_cs(jnp.asarray(a), jnp.asarray(b), **kwargs)
    got = metrics.compute_ssim_and_cs(torch.from_numpy(a), torch.from_numpy(b), **kwargs)
    atol = 1e-5 if spatial_dims == 2 else 5e-5
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


@pytest.mark.parametrize("reduction,get_not_nans", [("mean", False), ("none", False),
                                                    ("sum", True)])
def test_ssim_metric_matches_jax(reduction, get_not_nans):
    a, b = _pair((3, 1, 32, 32), seed=5)
    kwargs = dict(spatial_dims=2, reduction=reduction, get_not_nans=get_not_nans)
    want, got = _both(jax_metrics.SSIMMetric(**kwargs), metrics.SSIMMetric(**kwargs), a, b)
    if get_not_nans:
        assert float(got[1]) == float(want[1])
        want, got = want[0], got[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("spatial_dims,size,weights", [
    (2, 64, (0.0448, 0.2856, 0.3001)),
    (2, 176, (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)),
    (3, 48, (0.5, 0.5)),
])
def test_ms_ssim_matches_jax(spatial_dims, size, weights):
    a, b = _pair((2, 1) + (size,) * spatial_dims, seed=6, noise=0.05)
    kwargs = dict(spatial_dims=spatial_dims, data_range=1.0, weights=weights, reduction="none")
    want, got = _both(jax_metrics.MultiScaleSSIMMetric(**kwargs),
                      metrics.MultiScaleSSIMMetric(**kwargs), a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got.min()) > 0  # a real comparison, not two clamped zeros


def test_ms_ssim_rejects_small_images_as_jax():
    a = torch.zeros(1, 1, 32, 32)
    with pytest.raises(ValueError, match="image size must be larger than 160"):
        metrics.MultiScaleSSIMMetric(spatial_dims=2)(a, a)
    with pytest.raises(ValueError, match="image size must be larger than 160"):
        jax_metrics.MultiScaleSSIMMetric(spatial_dims=2)(jnp.zeros((1, 1, 32, 32)),
                                                         jnp.zeros((1, 1, 32, 32)))
