from .convert import (
    autoencoderkl_state_dict_from_jax,
    backbone_state_dict_from_jax,
    controlnet_state_dict_from_jax,
    diffusion_model_encoder_state_dict_from_jax,
    patchgan_state_dict_from_jax,
    unet_state_dict_from_jax,
    vqvae_state_dict_from_jax,
)

__all__ = [
    "autoencoderkl_state_dict_from_jax", "backbone_state_dict_from_jax",
    "controlnet_state_dict_from_jax",
    "diffusion_model_encoder_state_dict_from_jax", "patchgan_state_dict_from_jax",
    "unet_state_dict_from_jax", "vqvae_state_dict_from_jax",
]
