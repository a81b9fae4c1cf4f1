"""Tensor-parallel layers, single rank (the sharded forms come later)."""
from .layers import (ColumnParallelLinear, RowParallelLinear,
                     VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
