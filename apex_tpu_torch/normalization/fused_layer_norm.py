"""``FusedLayerNorm`` and ``MixedFusedLayerNorm``: the modules over the
LayerNorm kernels, and the functional ``fused_layer_norm``.

Port of ``apex_tpu/normalization/fused_layer_norm.py``: layer norm over
the trailing ``normalized_shape`` dimensions, with parameters named
``weight`` (ones) and ``bias`` (zeros) created fp32, as the flax
module's default ``param_dtype``, or none with
``elementwise_affine=False`` (the kernels' ``gamma=None`` lanes).
``MixedFusedLayerNorm`` is the same module meant for bf16/fp16
activations under fp32 gamma/beta (the kernels' mixed-dtype lanes).
``kernels=False`` runs the plain version under autograd instead (the
oracle configuration).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops.layer_norm import layer_norm, layer_norm_reference
from ..ops.layer_norm import fused_layer_norm as _fused

__all__ = ["FusedLayerNorm", "MixedFusedLayerNorm", "fused_layer_norm"]

Shape = Union[int, Sequence[int]]


def fused_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dimension, affine when ``weight`` and
    ``bias`` are given (JAX's functional ``fused_layer_norm``):
    differentiable, the kernels on CUDA tensors, their plain versions on
    CPU tensors."""
    return layer_norm(x, weight, bias, eps)


class FusedLayerNorm(nn.Module):
    """Layer norm with fp32 statistics; the output keeps x's dtype."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *, kernels: bool = True,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.kernels = kernels
        hidden = math.prod(self.normalized_shape)
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(hidden, device=device))
            self.bias = nn.Parameter(torch.zeros(hidden, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.normalized_shape)
        if tuple(x.shape[-n:]) != self.normalized_shape:
            raise ValueError(f"input trailing dims {tuple(x.shape[-n:])} != "
                             f"normalized_shape {self.normalized_shape}")
        shape = x.shape
        x2 = x.reshape(*shape[:-n], math.prod(self.normalized_shape))
        fn = _fused if self.kernels else layer_norm_reference
        return fn(x2, self.weight, self.bias, self.eps).reshape(shape)


class MixedFusedLayerNorm(FusedLayerNorm):
    """bf16/fp16 activations under fp32 gamma/beta (ref:
    ``apex/normalization/fused_layer_norm.py:202``): the output in x's
    dtype, dgamma/dbeta fp32."""
