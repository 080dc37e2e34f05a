from .convert import unet_state_dict_from_jax

__all__ = ["unet_state_dict_from_jax"]
