"""Quality metrics: FID on extracted features, MMD, SSIM and MS-SSIM.

Counterpart of generativemodels_tpu/metrics/: plain tensor code on any
device (no TPU kernel computes them in the JAX package).
"""
from .fid import FIDMetric, compute_frechet_distance, get_fid_score
from .mmd import MMDMetric
from .ssim import MultiScaleSSIMMetric, SSIMMetric, compute_ssim_and_cs

__all__ = [
    "FIDMetric",
    "compute_frechet_distance",
    "get_fid_score",
    "MMDMetric",
    "MultiScaleSSIMMetric",
    "SSIMMetric",
    "compute_ssim_and_cs",
]
