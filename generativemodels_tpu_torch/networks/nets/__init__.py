from .diffusion_model_unet import DiffusionModelUNet

__all__ = ["DiffusionModelUNet"]
