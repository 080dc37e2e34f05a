from .vector_quantizer import EMAQuantizer, VectorQuantizer

__all__ = ["EMAQuantizer", "VectorQuantizer"]
