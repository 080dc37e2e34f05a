from .attention_blocks import AttentionBlock
from .convolutions import ConvND, ConvTransposeND, avg_pool, upsample_nearest
from .layers import GroupNorm, Linear

__all__ = [
    "AttentionBlock", "ConvND", "ConvTransposeND", "GroupNorm", "Linear", "avg_pool",
    "upsample_nearest",
]
