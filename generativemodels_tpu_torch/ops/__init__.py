from .attention import dot_product_attention, resolve_use_flash
from .embeddings import get_timestep_embedding
from .flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_BWD_FUSED,
    FLASH_FWD,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)
from .fused_conv import (
    FUSED_CONV,
    fold_groupnorm_affine,
    fused_norm_silu_conv3d,
    fused_norm_silu_conv3d_reference,
)

__all__ = [
    "FLASH_BWD_DKV",
    "FLASH_BWD_DQ",
    "FLASH_BWD_FUSED",
    "FLASH_FWD",
    "FUSED_CONV",
    "dot_product_attention",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_reference",
    "flash_attention_reference",
    "flash_attention_with_lse",
    "fold_groupnorm_affine",
    "fused_norm_silu_conv3d",
    "fused_norm_silu_conv3d_reference",
    "get_timestep_embedding",
    "resolve_use_flash",
]
