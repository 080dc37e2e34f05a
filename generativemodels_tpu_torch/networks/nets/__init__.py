from .autoencoderkl import AEKLDecoder, AEKLEncoder, AEKLResBlock, AutoencoderKL
from .controlnet import ControlNet, ControlNetConditioningEmbedding, copy_weights_to_controlnet
from .diffusion_model_unet import DiffusionModelEncoder, DiffusionModelUNet
from .patchgan_discriminator import MultiScalePatchDiscriminator, PatchDiscriminator
from .vqvae import VQVAE, VQVAEDecoder, VQVAEEncoder, VQVAEResidualUnit

__all__ = [
    "AEKLDecoder", "AEKLEncoder", "AEKLResBlock", "AutoencoderKL", "ControlNet",
    "ControlNetConditioningEmbedding", "DiffusionModelEncoder", "DiffusionModelUNet",
    "MultiScalePatchDiscriminator", "PatchDiscriminator", "VQVAE", "VQVAEDecoder",
    "VQVAEEncoder", "VQVAEResidualUnit", "copy_weights_to_controlnet",
]
