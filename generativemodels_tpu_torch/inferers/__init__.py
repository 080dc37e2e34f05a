from .inferer import DiffusionInferer

__all__ = ["DiffusionInferer"]
