from .attention_blocks import AttentionBlock
from .convolutions import ConvND, avg_pool, upsample_nearest
from .layers import GroupNorm, Linear

__all__ = ["AttentionBlock", "ConvND", "GroupNorm", "Linear", "avg_pool", "upsample_nearest"]
