from .attention_blocks import (
    AttentionBlock,
    BasicTransformerBlock,
    CrossAttention,
    SpatialTransformer,
)
from .convolutions import ConvND, ConvTransposeND, avg_pool, upsample_nearest
from .encoder_modules import SpatialRescaler
from .layers import GroupNorm, LayerNorm, Linear
from .mlp import MLPBlock
from .selfattention import KVCache, SABlock, TransformerBlock
from .spade_norm import SPADE

__all__ = [
    "AttentionBlock", "BasicTransformerBlock", "ConvND", "ConvTransposeND", "CrossAttention",
    "GroupNorm", "KVCache", "LayerNorm", "Linear", "MLPBlock", "SABlock", "SPADE",
    "SpatialRescaler", "SpatialTransformer", "TransformerBlock", "avg_pool", "upsample_nearest",
]
