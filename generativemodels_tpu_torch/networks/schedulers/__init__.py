from .ddim import DDIMPredictionType, DDIMScheduler
from .ddpm import DDPMPredictionType, DDPMScheduler, DDPMVarianceType
from .scheduler import NoiseSchedules, Scheduler

__all__ = [
    "DDIMPredictionType",
    "DDIMScheduler",
    "DDPMPredictionType",
    "DDPMScheduler",
    "DDPMVarianceType",
    "NoiseSchedules",
    "Scheduler",
]
