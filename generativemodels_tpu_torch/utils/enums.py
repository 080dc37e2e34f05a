"""Enumerations shared across the port.

Counterpart of generativemodels_tpu/utils/enums.py: `StrEnum`, the
adversarial output keys and the adversarial step's hook points. The
ordering enums wait for the autoregressive slice.
"""
from __future__ import annotations

from enum import Enum


class StrEnum(str, Enum):
    """String-valued enum whose members compare equal to their value."""

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return self.value


class AdversarialKeys(StrEnum):
    REALS = "reals"
    REAL_LOGITS = "real_logits"
    FAKES = "fakes"
    FAKE_LOGITS = "fake_logits"
    RECONSTRUCTION_LOSS = "reconstruction_loss"
    GENERATOR_LOSS = "generator_loss"
    DISCRIMINATOR_LOSS = "discriminator_loss"


class AdversarialIterationEvents(StrEnum):
    """Hook points of the adversarial training step, in the order
    `engines.AdversarialTrainer` fires them after each step."""

    RECONSTRUCTION_LOSS_COMPLETED = "reconstruction_loss_completed"
    GENERATOR_FORWARD_COMPLETED = "generator_forward_completed"
    GENERATOR_DISCRIMINATOR_FORWARD_COMPLETED = "generator_discriminator_forward_completed"
    GENERATOR_LOSS_COMPLETED = "generator_loss_completed"
    GENERATOR_BACKWARD_COMPLETED = "generator_backward_completed"
    GENERATOR_MODEL_COMPLETED = "generator_model_completed"
    DISCRIMINATOR_REALS_FORWARD_COMPLETED = "discriminator_reals_forward_completed"
    DISCRIMINATOR_FAKES_FORWARD_COMPLETED = "discriminator_fakes_forward_completed"
    DISCRIMINATOR_LOSS_COMPLETED = "discriminator_loss_completed"
    DISCRIMINATOR_BACKWARD_COMPLETED = "discriminator_backward_completed"
    DISCRIMINATOR_MODEL_COMPLETED = "discriminator_model_completed"
