"""Fused optimizers."""
from .fused_adam import FusedAdam, FusedAdamState, fused_adam

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]
