from .inferer import DiffusionInferer
from .latent import LatentDiffusionInferer

__all__ = ["DiffusionInferer", "LatentDiffusionInferer"]
