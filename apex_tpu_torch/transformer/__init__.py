"""Transformer building blocks (single rank)."""
from .layers import (ParallelMLP, ParallelSelfAttention, ParallelTransformer,
                     ParallelTransformerLayer)

__all__ = ["ParallelMLP", "ParallelSelfAttention", "ParallelTransformerLayer",
           "ParallelTransformer"]
