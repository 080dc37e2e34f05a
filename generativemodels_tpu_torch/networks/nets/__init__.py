from .autoencoderkl import AEKLDecoder, AEKLEncoder, AEKLResBlock, AutoencoderKL
from .controlnet import ControlNet, ControlNetConditioningEmbedding, copy_weights_to_controlnet
from .diffusion_model_unet import DiffusionModelEncoder, DiffusionModelUNet

__all__ = [
    "AEKLDecoder", "AEKLEncoder", "AEKLResBlock", "AutoencoderKL", "ControlNet",
    "ControlNetConditioningEmbedding", "DiffusionModelEncoder", "DiffusionModelUNet",
    "copy_weights_to_controlnet",
]
