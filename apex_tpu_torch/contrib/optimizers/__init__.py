"""Contributed optimizers: ZeRO-sharded Adam over a process group."""
from .distributed_fused_adam import (DistributedFusedAdam,
                                     DistributedFusedAdamState,
                                     distributed_fused_adam)

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamState",
           "distributed_fused_adam"]
