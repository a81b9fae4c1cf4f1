"""Fused normalization modules."""
from .fused_layer_norm import (FusedLayerNorm, MixedFusedLayerNorm,
                               fused_layer_norm)

__all__ = ["FusedLayerNorm", "MixedFusedLayerNorm", "fused_layer_norm"]
