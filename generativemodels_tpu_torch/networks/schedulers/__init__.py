from .ddim import DDIMPredictionType, DDIMScheduler
from .ddpm import DDPMPredictionType, DDPMScheduler, DDPMVarianceType
from .dpmsolver import (
    DPMSolverAlgorithmType,
    DPMSolverMultistepScheduler,
    DPMSolverPredictionType,
    DPMSolverState,
)
from .pndm import PNDMPredictionType, PNDMScheduler, PNDMState
from .scheduler import NoiseSchedules, Scheduler

__all__ = [
    "DDIMPredictionType",
    "DDIMScheduler",
    "DDPMPredictionType",
    "DDPMScheduler",
    "DDPMVarianceType",
    "DPMSolverAlgorithmType",
    "DPMSolverMultistepScheduler",
    "DPMSolverPredictionType",
    "DPMSolverState",
    "NoiseSchedules",
    "PNDMPredictionType",
    "PNDMScheduler",
    "PNDMState",
    "Scheduler",
]
