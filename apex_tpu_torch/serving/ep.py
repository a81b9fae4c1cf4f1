"""MoE serving weights: :func:`expand_moe_weights`.

Port of ``apex_tpu/serving/ep.py:87`` ``expand_moe_weights``, the one
piece of JAX's expert-parallel serving that a single device needs.
``EPContext`` and ``serving_ep_plan`` (experts sharded over a mesh axis)
are not ported (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Optional

import torch

from .model import GPTServingWeights, MoELayerWeights

__all__ = ["expand_moe_weights"]


def expand_moe_weights(weights: GPTServingWeights, num_experts: int,
                       generator: Optional[torch.Generator] = None
                       ) -> GPTServingWeights:
    """Dense serving weights -> a ``num_experts``-way MoE model: every
    layer's fc1/fc2 kernel is tiled into the (E, H, F) / (E, F, H) expert
    stacks (all experts start as the dense FFN) and the fc biases are
    dropped (the expert stacks are bias-free, so exact dense equivalence
    needs zero fc biases).  Each layer's fp32 router is ``0.02 * randn(H,
    E)`` drawn in layer order from ``generator`` (on the weights' device),
    or zeros when it is None: uniform routing, fully deterministic."""
    e = int(num_experts)
    if e < 1:
        raise ValueError(f"num_experts {e} must be >= 1")
    layers = []
    for lw in weights.layers:
        h = lw.fc1_k.shape[0]
        dev = lw.fc1_k.device
        if generator is None:
            router = torch.zeros((h, e), dtype=torch.float32, device=dev)
        else:
            router = 0.02 * torch.randn((h, e), generator=generator,
                                        dtype=torch.float32, device=dev)
        layers.append(MoELayerWeights(
            ln1_w=lw.ln1_w, ln1_b=lw.ln1_b, qkv_k=lw.qkv_k, qkv_b=lw.qkv_b,
            dense_k=lw.dense_k, dense_b=lw.dense_b, ln2_w=lw.ln2_w,
            ln2_b=lw.ln2_b, router=router,
            wi=lw.fc1_k[None].expand(e, *lw.fc1_k.shape).clone(),
            wo=lw.fc2_k[None].expand(e, *lw.fc2_k.shape).clone()))
    return weights._replace(layers=tuple(layers))
