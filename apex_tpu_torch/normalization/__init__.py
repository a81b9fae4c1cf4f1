"""Fused normalization modules."""
from .fused_layer_norm import FusedLayerNorm

__all__ = ["FusedLayerNorm"]
