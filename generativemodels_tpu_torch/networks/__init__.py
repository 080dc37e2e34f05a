from .convert import (
    autoencoderkl_state_dict_from_jax,
    backbone_state_dict_from_jax,
    controlnet_state_dict_from_jax,
    diffusion_model_encoder_state_dict_from_jax,
    patchgan_state_dict_from_jax,
    semantic_encoder_state_dict_from_jax,
    spade_autoencoderkl_state_dict_from_jax,
    spade_diffusion_model_unet_state_dict_from_jax,
    spade_network_state_dict_from_jax,
    transformer_state_dict_from_jax,
    unet_state_dict_from_jax,
    vqvae_state_dict_from_jax,
)
from .pretrained import load_reference_checkpoint

__all__ = [
    "autoencoderkl_state_dict_from_jax", "backbone_state_dict_from_jax",
    "controlnet_state_dict_from_jax", "load_reference_checkpoint",
    "diffusion_model_encoder_state_dict_from_jax", "patchgan_state_dict_from_jax",
    "semantic_encoder_state_dict_from_jax",
    "spade_autoencoderkl_state_dict_from_jax", "spade_diffusion_model_unet_state_dict_from_jax",
    "spade_network_state_dict_from_jax", "transformer_state_dict_from_jax",
    "unet_state_dict_from_jax", "vqvae_state_dict_from_jax",
]
