"""``FusedLayerNorm``: the module over the LayerNorm kernels.

Port of ``apex_tpu/normalization/fused_layer_norm.py:29-64``: layer norm
over the trailing ``normalized_shape`` dimensions with parameters named
``weight`` (ones) and ``bias`` (zeros), created fp32, as the flax
module's default ``param_dtype`` (the non-affine form is not ported).  ``kernels=False`` runs the plain
version under autograd instead (the oracle configuration).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
from torch import nn

from ..ops.layer_norm import fused_layer_norm, layer_norm_reference

__all__ = ["FusedLayerNorm"]

Shape = Union[int, Sequence[int]]


class FusedLayerNorm(nn.Module):
    """Layer norm with fp32 statistics; the output keeps x's dtype."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5, *,
                 kernels: bool = True, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.kernels = kernels
        hidden = math.prod(self.normalized_shape)
        self.weight = nn.Parameter(torch.ones(hidden, device=device))
        self.bias = nn.Parameter(torch.zeros(hidden, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.normalized_shape)
        if tuple(x.shape[-n:]) != self.normalized_shape:
            raise ValueError(f"input trailing dims {tuple(x.shape[-n:])} != "
                             f"normalized_shape {self.normalized_shape}")
        shape = x.shape
        x2 = x.reshape(*shape[:-n], math.prod(self.normalized_shape))
        fn = fused_layer_norm if self.kernels else layer_norm_reference
        return fn(x2, self.weight, self.bias, self.eps).reshape(shape)
