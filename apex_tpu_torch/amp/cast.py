"""Parameter casting: the O2/O5 network conversion and master copies.

Port of ``apex_tpu/amp/cast.py`` (``convert_network``, the batch-norm
name predicate, ``master_copy``) for an ``nn.Module``: a parameter is
named by its dotted path, and it stays fp32 under
``keep_batchnorm_fp32`` only when one component of that path looks
like a batch-norm layer.  LayerNorm parameters (``input_layernorm``,
``final_layernorm``) do not, so under O5 they become bf16, as in the
JAX package.
"""
from __future__ import annotations

import re
from typing import Dict

import torch
from torch import nn

__all__ = ["default_bn_predicate", "convert_network", "cast_params",
           "master_copy"]

# the JAX package's pattern (apex_tpu/amp/cast.py:22)
_BN_PAT = re.compile(r"(batch_?norm|(^|[^a-z])bn([^a-z]|$))", re.IGNORECASE)


def default_bn_predicate(name: str) -> bool:
    """Whether the dotted parameter name belongs to a batch-norm layer."""
    return any(_BN_PAT.search(part) for part in name.split("."))


def convert_network(module: nn.Module, dtype: torch.dtype,
                    keep_batchnorm_fp32: bool = True) -> nn.Module:
    """Cast every floating parameter of ``module`` to ``dtype`` in place,
    keeping batch-norm parameters (:func:`default_bn_predicate`) fp32
    when asked; returns the module."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if not p.is_floating_point():
                continue
            want = torch.float32 if keep_batchnorm_fp32 and \
                default_bn_predicate(name) else dtype
            if p.dtype != want:
                p.data = p.data.to(want)
    return module


def cast_params(module: nn.Module, policy) -> nn.Module:
    """Apply a :class:`~apex_tpu_torch.amp.Policy`'s model cast."""
    if policy.cast_model_type is None:
        return module
    keep_bn = policy.keep_batchnorm_fp32
    return convert_network(module, policy.cast_model_type,
                           True if keep_bn is None else keep_bn)


def master_copy(module: nn.Module) -> Dict[str, torch.Tensor]:
    """fp32 copies of the module's parameters, by name."""
    return {name: p.detach().to(torch.float32, copy=True)
            for name, p in module.named_parameters()}
