"""Patch adversarial loss (least squares / BCE / hinge) and feature matching.

Counterpart of generativemodels_tpu/losses/adversarial_loss.py:
`PatchAdversarialLoss` over raw discriminator outputs (one tensor or a list,
one per discriminator), with each criterion's activation, the generator's
forced real target, hinge = -mean(min(+-D - 1, 0)); and
`feature_matching_loss` over the discriminators' intermediate features,
the real features detached.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from ..utils import StrEnum


class AdversarialCriterions(StrEnum):
    BCE = "bce"
    HINGE = "hinge"
    LEAST_SQUARE = "least_squares"


class PatchAdversarialLoss:
    """Adversarial loss over raw (pre-activation) discriminator outputs.

    Args:
        reduction: "none" | "mean" | "sum" over the per-discriminator losses.
        criterion: "bce" | "hinge" | "least_squares".
        no_activation_leastsq: drop the leaky-relu pre-activation for LSGAN.
    """

    def __init__(
        self,
        reduction: str = "mean",
        criterion: str = AdversarialCriterions.LEAST_SQUARE.value,
        no_activation_leastsq: bool = False,
    ) -> None:
        if criterion.lower() not in [m.value for m in AdversarialCriterions]:
            raise ValueError(
                "Unrecognised criterion entered for Adversarial Loss. Must be one in: %s"
                % ", ".join([m.value for m in AdversarialCriterions])
            )
        if reduction not in ("none", "mean", "sum"):
            raise ValueError("reduction must be one of 'none', 'mean', 'sum'")
        self.real_label = 1.0
        self.fake_label = 0.0
        self.activation = None
        if criterion == AdversarialCriterions.BCE.value:
            self.activation = torch.sigmoid
        elif criterion == AdversarialCriterions.HINGE.value:
            self.activation = torch.tanh
            self.fake_label = -1.0
        elif criterion == AdversarialCriterions.LEAST_SQUARE.value and not no_activation_leastsq:
            self.activation = lambda x: F.leaky_relu(x, 0.05)
        self.criterion = criterion
        self.reduction = reduction

    def get_target_tensor(self, input: torch.Tensor, target_is_real: bool) -> torch.Tensor:
        """The real or fake label, shaped like `input`."""
        return torch.full_like(input, self.real_label if target_is_real else self.fake_label)

    def get_zero_tensor(self, input: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(input)

    def forward_single(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """The criterion between one activated discriminator output and its
        target; hinge ignores `target` and always takes the mean."""
        if self.criterion == AdversarialCriterions.BCE.value:
            p = torch.clamp(input, 1e-7, 1 - 1e-7)
            elems = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
        elif self.criterion == AdversarialCriterions.LEAST_SQUARE.value:
            elems = (input - target) ** 2
        else:
            return -torch.mean(torch.minimum(input - 1.0, self.get_zero_tensor(input)))
        if self.reduction == "sum":
            return torch.sum(elems)
        if self.reduction == "none":
            return elems
        return torch.mean(elems)

    def _single(self, disc_out: torch.Tensor, target_is_real: bool) -> torch.Tensor:
        if self.activation is not None:
            disc_out = self.activation(disc_out)
        if self.criterion == AdversarialCriterions.HINGE.value:
            target = self.get_zero_tensor(disc_out)
            if not target_is_real:
                disc_out = -disc_out
        else:
            target = self.get_target_tensor(disc_out, target_is_real)
        return self.forward_single(disc_out, target)

    def __call__(self, input, target_is_real: bool, for_discriminator: bool):
        """The loss of one or several discriminator outputs; a generator's
        target is always real."""
        if not for_discriminator and not target_is_real:
            target_is_real = True
            warnings.warn(
                "Variable target_is_real has been set to False, but for_discriminator is set "
                "to False. To optimise a generator, target_is_real must be set to True."
            )
        if not isinstance(input, list):
            input = [input]
        losses = [self._single(d, target_is_real) for d in input]
        if self.reduction == "mean":
            return torch.mean(torch.stack(losses))
        if self.reduction == "sum":
            return torch.sum(torch.stack(losses))
        return losses


def feature_matching_loss(real_features, fake_features) -> torch.Tensor:
    """Pix2PixHD feature matching: the mean over feature pairs of
    mean|real - fake|, the real features detached. Takes per-discriminator
    lists (multi-scale) or flat feature lists."""
    if real_features and isinstance(real_features[0], (list, tuple)):
        pairs = [(r, f) for rs, fs in zip(real_features, fake_features) for r, f in zip(rs, fs)]
    else:
        pairs = list(zip(real_features, fake_features))
    if not pairs:
        raise ValueError("feature_matching_loss needs at least one feature pair")
    return torch.mean(torch.stack([torch.mean(torch.abs(r.detach() - f)) for r, f in pairs]))
