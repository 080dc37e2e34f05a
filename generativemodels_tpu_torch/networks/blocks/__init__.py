from .attention_blocks import AttentionBlock
from .convolutions import ConvND, avg_pool, upsample_nearest

__all__ = ["AttentionBlock", "ConvND", "avg_pool", "upsample_nearest"]
