from .autoencoderkl import AEKLDecoder, AEKLEncoder, AEKLResBlock, AutoencoderKL
from .diffusion_model_unet import DiffusionModelUNet

__all__ = ["AEKLDecoder", "AEKLEncoder", "AEKLResBlock", "AutoencoderKL", "DiffusionModelUNet"]
