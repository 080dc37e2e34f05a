from .attention import dot_product_attention, resolve_use_flash
from .embeddings import get_timestep_embedding
from .flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)

__all__ = [
    "FLASH_BWD_DKV",
    "FLASH_BWD_DQ",
    "FLASH_FWD",
    "dot_product_attention",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_reference",
    "flash_attention_reference",
    "flash_attention_with_lse",
    "get_timestep_embedding",
    "resolve_use_flash",
]
