from .autoencoderkl import AEKLDecoder, AEKLEncoder, AEKLResBlock, AutoencoderKL
from .controlnet import ControlNet, ControlNetConditioningEmbedding, copy_weights_to_controlnet
from .diffusion_model_unet import DiffusionModelEncoder, DiffusionModelUNet
from .patchgan_discriminator import MultiScalePatchDiscriminator, PatchDiscriminator
from .spade_autoencoderkl import SPADEAEKLDecoder, SPADEAEKLResBlock, SPADEAutoencoderKL
from .spade_diffusion_model_unet import SPADEDiffusionModelUNet, SPADEResnetBlock, SPADEUpBlock
from .spade_network import SPADENet, SPADENetDecoder, SPADENetEncoder, SPADENetResNetBlock
from .transformer import DecoderOnlyTransformer, TransformerCache
from .vqvae import VQVAE, VQVAEDecoder, VQVAEEncoder, VQVAEResidualUnit

__all__ = [
    "AEKLDecoder", "AEKLEncoder", "AEKLResBlock", "AutoencoderKL", "ControlNet",
    "ControlNetConditioningEmbedding", "DecoderOnlyTransformer", "DiffusionModelEncoder",
    "DiffusionModelUNet", "MultiScalePatchDiscriminator", "PatchDiscriminator",
    "SPADEAEKLDecoder", "SPADEAEKLResBlock", "SPADEAutoencoderKL", "SPADEDiffusionModelUNet",
    "SPADENet", "SPADENetDecoder", "SPADENetEncoder", "SPADENetResNetBlock", "SPADEResnetBlock",
    "SPADEUpBlock", "TransformerCache", "VQVAE", "VQVAEDecoder", "VQVAEEncoder",
    "VQVAEResidualUnit", "copy_weights_to_controlnet",
]
