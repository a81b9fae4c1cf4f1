"""Fused optimizers."""
from .fused_adam import FusedAdam, FusedAdamState, fused_adam
from .fused_lamb import FusedLAMB, FusedLAMBState, fused_lamb
from .fused_sgd import FusedSGD, FusedSGDState, fused_sgd

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam", "FusedLAMB",
           "FusedLAMBState", "fused_lamb", "FusedSGD", "FusedSGDState",
           "fused_sgd"]
