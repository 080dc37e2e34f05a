from .controlnet import ControlNetDiffusionInferer, ControlNetLatentDiffusionInferer
from .inferer import DiffusionInferer
from .latent import LatentDiffusionInferer
from .vqvae_transformer import VQVAETransformerInferer, resolve_use_cache

__all__ = [
    "ControlNetDiffusionInferer", "ControlNetLatentDiffusionInferer", "DiffusionInferer",
    "LatentDiffusionInferer", "VQVAETransformerInferer", "resolve_use_cache",
]
