from .train import (
    DiffusionTrainStep,
    TrainState,
    init_train_state,
    make_diffusion_train_step,
    make_multi_step_train,
)

__all__ = [
    "DiffusionTrainStep",
    "TrainState",
    "init_train_state",
    "make_diffusion_train_step",
    "make_multi_step_train",
]
