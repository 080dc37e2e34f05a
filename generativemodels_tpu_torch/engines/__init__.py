from .prepare_batch import DiffusionPrepareBatch, VPredictionPrepareBatch
from .trainer import (
    AdversarialTrainer,
    AdversarialTrainState,
    AdversarialTrainStep,
    init_adversarial_state,
    make_adversarial_train_step,
)

__all__ = [
    "AdversarialTrainStep",
    "AdversarialTrainState",
    "AdversarialTrainer",
    "DiffusionPrepareBatch",
    "VPredictionPrepareBatch",
    "init_adversarial_state",
    "make_adversarial_train_step",
]
