"""Transformer functional modules (single rank)."""
from .fused_softmax import FusedScaleMaskSoftmax

__all__ = ["FusedScaleMaskSoftmax"]
