from .attention_blocks import (
    AttentionBlock,
    BasicTransformerBlock,
    CrossAttention,
    SpatialTransformer,
)
from .convolutions import ConvND, ConvTransposeND, avg_pool, upsample_nearest
from .layers import GroupNorm, LayerNorm, Linear
from .mlp import MLPBlock

__all__ = [
    "AttentionBlock", "BasicTransformerBlock", "ConvND", "ConvTransposeND", "CrossAttention",
    "GroupNorm", "LayerNorm", "Linear", "MLPBlock", "SpatialTransformer", "avg_pool",
    "upsample_nearest",
]
