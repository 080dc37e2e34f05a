from .controlnet import ControlNetDiffusionInferer, ControlNetLatentDiffusionInferer
from .inferer import DiffusionInferer
from .latent import LatentDiffusionInferer

__all__ = [
    "ControlNetDiffusionInferer", "ControlNetLatentDiffusionInferer", "DiffusionInferer",
    "LatentDiffusionInferer",
]
