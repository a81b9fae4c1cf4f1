"""Tensor-parallel layers, single rank (the sharded forms come later)."""
from .layers import (ColumnParallelLinear, RowParallelLinear,
                     VocabParallelEmbedding)
from .random import CHECKPOINT_POLICIES, checkpoint

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "CHECKPOINT_POLICIES", "checkpoint"]
