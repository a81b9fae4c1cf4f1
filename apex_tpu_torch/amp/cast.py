"""Parameter casting: the O2/O5 network conversion and master copies,
and the casts of trees of tensors.

Port of ``apex_tpu/amp/cast.py`` (``convert_network``, the batch-norm
name predicate, ``master_copy``, ``tree_cast``, ``cast_inputs``,
``cast_outputs``, ``restore_dtypes``) for an ``nn.Module`` and trees of
tensors (a tensor, or dicts, lists and tuples of them: named tensors are
a dict by name).  For a module a parameter is
named by its dotted path, and it stays fp32 under
``keep_batchnorm_fp32`` only when one component of that path looks
like a batch-norm layer.  LayerNorm parameters (``input_layernorm``,
``final_layernorm``) do not, so under O5 they become bf16, as in the
JAX package.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import torch
from torch import nn

__all__ = ["default_bn_predicate", "convert_network", "cast_params",
           "cast_dtype", "master_copy", "tree_cast", "cast_inputs",
           "cast_outputs", "restore_dtypes"]

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
            want = _target(name, p, dtype, keep_batchnorm_fp32)
            if p.dtype != want:
                p.data = p.data.to(want)
    return module


def _target(name: str, p: torch.Tensor, dtype: torch.dtype,
            keep_batchnorm_fp32: bool) -> torch.dtype:
    if not p.is_floating_point():
        return p.dtype
    return torch.float32 if keep_batchnorm_fp32 and \
        default_bn_predicate(name) else dtype


def cast_dtype(name: str, p: torch.Tensor, policy) -> torch.dtype:
    """The dtype :func:`cast_params` gives parameter ``name`` under
    ``policy``, from its name and dtype alone (a parameter on the
    ``meta`` device will do)."""
    if policy.cast_model_type is None:
        return p.dtype
    keep_bn = policy.keep_batchnorm_fp32
    return _target(name, p, policy.cast_model_type,
                   True if keep_bn is None else keep_bn)


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


def _tree_map(f, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, *xs) for xs in zip(tree, *rest))
    return f(tree, *rest)


def tree_cast(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of ``tree`` cast to ``dtype``; other leaves
    (integer tensors, non-tensors) as they are."""
    return _tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else x, tree)


def cast_inputs(args: Any, policy) -> Any:
    """Model inputs in the model dtype (the patched ``forward``'s entry
    cast, ref: apex/amp/_initialize.py:190-199); unchanged without a
    model cast."""
    if policy.cast_model_type is None:
        return args
    return tree_cast(args, policy.cast_model_type)


def cast_outputs(outputs: Any, policy) -> Any:
    """Model outputs in ``policy.cast_model_outputs``, fp32 by default
    under a model cast (O2/O3/O5); unchanged otherwise."""
    out_dtype = policy.cast_model_outputs
    if out_dtype is None and policy.cast_model_type is not None:
        out_dtype = torch.float32
    if out_dtype is None:
        return outputs
    return tree_cast(outputs, out_dtype)


def restore_dtypes(src: Any, like: Any) -> Any:
    """``src`` cast leaf by leaf to the dtypes of ``like`` (a tree of the
    same structure, of tensors or anything with a ``dtype``) where that
    dtype is floating (the master -> model writeback)."""
    def one(s, ref):
        dt = getattr(ref, "dtype", None)
        if dt is not None and dt.is_floating_point and \
                isinstance(s, torch.Tensor):
            return s.to(dt)
        return s
    return _tree_map(one, src, like)
