"""Column/row-parallel linear and vocab-parallel embedding, single rank.

Port of ``apex_tpu/transformer/tensor_parallel/layers.py`` with
``axis_name=None`` on one device: the parameters are the full logical
arrays and keep the Flax layout — ``kernel`` (in, out), ``bias`` (out,),
``embedding`` (vocab, hidden) — and the math is the JAX modules' own:
``x.to(dtype) @ kernel.to(dtype) + bias.to(dtype)`` (the bias added in
the compute dtype after the product, ``layers.py:122-140, 196-199``) and
``embedding.to(dtype)`` gathered by id or, for the tied LM head,
``x.to(dtype) @ embedding.to(dtype).T`` (``layers.py:246-266``).  The
products go to ``torch.matmul``, as the JAX package leaves them to XLA.
Sharding over ``torch.distributed`` is later work.

Parameters are created fp32 (the flax ``param_dtype``) on ``device`` and
drawn by :meth:`reset_parameters` from an explicit ``torch.Generator``:
kernels normal with variance 1/fan_in (flax's ``lecun_normal``, not
truncated), biases zero, embeddings normal(0, 0.02).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]

_EMBED_STD = 0.02


class _Linear(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 use_bias: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(input_size, output_size,
                                               device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(output_size,
                                                 device=device))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        std = self.input_size ** -0.5
        self.kernel.copy_(torch.randn(self.kernel.shape, generator=generator,
                                      device=self.kernel.device) * std)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class ColumnParallelLinear(_Linear):
    """Y = XA + b with A split by columns (one rank: the whole of A)."""


class RowParallelLinear(_Linear):
    """Y = XA + b with A split by rows (one rank: the whole of A); the
    bias is added once, after the (here trivial) reduction."""


class VocabParallelEmbedding(nn.Module):
    """Token embedding over the vocabulary (one rank: the whole table),
    with :meth:`attend` for the tied LM head."""

    def __init__(self, num_embeddings: int, features: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_embeddings, self.features = num_embeddings, features
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features,
                                                  device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embedding.copy_(torch.randn(
            self.embedding.shape, generator=generator,
            device=self.embedding.device) * _EMBED_STD)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding.to(self.dtype))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of the tied head: ``x @ embedding.T`` in the compute
        dtype."""
        return torch.matmul(x.to(self.dtype),
                            self.embedding.to(self.dtype).t())
