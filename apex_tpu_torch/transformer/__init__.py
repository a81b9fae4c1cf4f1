"""Transformer building blocks (single rank), and the Switch/GShard MoE
with every expert local."""
from .expert_parallel import (ExpertParallelMLP, RouterOutput,
                              Top2RouterOutput, moe_dispatch_combine,
                              moe_dispatch_combine_fused, top1_router,
                              top2_router)
from .layers import (DropoutRNG, ParallelMLP, ParallelSelfAttention,
                     ParallelTransformer, ParallelTransformerLayer)

__all__ = ["ParallelMLP", "ParallelSelfAttention", "ParallelTransformerLayer",
           "ParallelTransformer", "DropoutRNG", "ExpertParallelMLP",
           "RouterOutput",
           "Top2RouterOutput", "top1_router", "top2_router",
           "moe_dispatch_combine", "moe_dispatch_combine_fused"]
