"""Maximum Mean Discrepancy metric.

Counterpart of generativemodels_tpu/metrics/mmd.py (MMDMetric: the
linear-kernel MMD with optional y / y_pred transforms).
"""
from __future__ import annotations

from typing import Callable

import torch


class MMDMetric:
    """Linear-kernel MMD between two image batches (B, C, *spatial)."""

    def __init__(
        self,
        y_transform: Callable | None = None,
        y_pred_transform: Callable | None = None,
    ) -> None:
        self.y_transform = y_transform
        self.y_pred_transform = y_pred_transform

    def __call__(self, y: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        beta = 1.0
        gamma = 2.0

        if self.y_transform is not None:
            y = self.y_transform(y)
        if self.y_pred_transform is not None:
            y_pred = self.y_pred_transform(y_pred)

        if y_pred.shape != y.shape:
            raise ValueError(
                "y_pred and y shapes dont match after being processed by their "
                f"transforms, received y_pred: {tuple(y_pred.shape)} and y: {tuple(y.shape)}"
            )

        y = y.reshape(y.shape[0], -1)
        y_pred = y_pred.reshape(y_pred.shape[0], -1)

        n_features = y.shape[1]
        y_y = (y @ y.T) / n_features
        y_pred_y_pred = (y_pred @ y_pred.T) / n_features
        y_pred_y = (y_pred @ y.T) / n_features

        return beta * (torch.mean(y_y) + torch.mean(y_pred_y_pred)) - gamma * torch.mean(y_pred_y)
