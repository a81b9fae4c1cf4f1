"""Cast lists: JAX's primitive classes and the torch functions that lower
to them.

Port of ``apex_tpu/amp/lists.py``.  The JAX package classifies the XLA
primitives a traced function binds; the four sets below are its, kept as
data.  :mod:`apex_tpu_torch.amp.autocast` sees torch functions and
``Tensor`` methods instead, so :data:`TORCH_FUNCTION_CLASSES` maps each
one the port's models reach (and a user's commonly would) to the JAX
class of the primitive it lowers to:

- ``LOW_PRECISION`` (``dot_general``, ``conv_general_dilated``): matmuls,
  linear layers, einsum and convolutions — operands rounded to the
  compute dtype, a product's result in the traced preferred type (fp32
  from fp32 operands), a convolution's in the compute dtype.
- ``FP32``: numerically sensitive functions — transcendentals, powers,
  division, cumulative sums, norms, softmax and GELU (in JAX they
  decompose into ``exp`` / ``tanh`` / ``div`` / ``reduce_sum``, so the
  whole op ends in fp32).
- ``FP32_ACCUMULATE``: ``sum``, ``mean``, ``var``: ``jnp``'s versions
  accumulate in fp32 (``reduce_sum`` is FP32) and cast the result back to
  the input's dtype, so under the JAX interpreter they return the input's
  dtype; the port computes them in fp32 and casts back the same way.
- everything else: the input dtypes, mixed floating operands promoted
  to the widest (``PROMOTE_PRIMS`` documents the reference's explicit
  list; the rule applies to any function).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["LOW_PRECISION_PRIMS", "FP32_PRIMS", "PROMOTE_PRIMS",
           "RECURSE_PRIMS", "OPAQUE_PRIMS", "LOW_PRECISION", "FP32",
           "FP32_ACCUMULATE", "PROMOTE", "TORCH_FUNCTION_CLASSES"]

# --- the JAX package's primitive classes (apex_tpu/amp/lists.py) ------

LOW_PRECISION_PRIMS = frozenset({
    "dot_general",
    "conv_general_dilated",
    "ragged_dot_general",
})

FP32_PRIMS = frozenset({
    "exp", "exp2", "expm1",
    "log", "log1p",
    "pow", "integer_pow",
    "rsqrt", "sqrt",
    "sinh", "cosh", "tanh", "tan",
    "asin", "acos", "atan", "atan2",
    "asinh", "acosh", "atanh",
    "erf", "erfc", "erf_inv",
    "lgamma", "digamma",
    "logistic",
    "cumsum", "cumlogsumexp", "cumprod",
    "reduce_sum", "reduce_prod",
    "div",
})

PROMOTE_PRIMS = frozenset({
    "add", "sub", "mul", "max", "min", "rem",
    "atan2", "nextafter", "select_n", "concatenate",
})

RECURSE_PRIMS = frozenset({"jit", "pjit", "closed_call", "core_call",
                           "remat", "remat2", "checkpoint"})
# custom_vjp call sites: opaque to the interpreter.  The port's
# counterparts are its fused entries, wrapped in
# apex_tpu_torch._autocast_ctx.opaque.
OPAQUE_PRIMS = frozenset({
    "custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr",
    "custom_root", "custom_linear_solve",
})

# --- the torch side ------------------------------------------------------

LOW_PRECISION = "low_precision"
FP32 = "fp32"
FP32_ACCUMULATE = "fp32_accumulate"
PROMOTE = "promote"

# name -> (class, the JAX primitive it lowers to)
_BY_NAME = {
    # dot_general / conv_general_dilated
    "linear": (LOW_PRECISION, "dot_general"),
    "matmul": (LOW_PRECISION, "dot_general"),
    "__matmul__": (LOW_PRECISION, "dot_general"),
    "__rmatmul__": (LOW_PRECISION, "dot_general"),
    "mm": (LOW_PRECISION, "dot_general"),
    "bmm": (LOW_PRECISION, "dot_general"),
    "addmm": (LOW_PRECISION, "dot_general"),
    "baddbmm": (LOW_PRECISION, "dot_general"),
    "einsum": (LOW_PRECISION, "dot_general"),
    "conv1d": (LOW_PRECISION, "conv_general_dilated"),
    "conv2d": (LOW_PRECISION, "conv_general_dilated"),
    "conv3d": (LOW_PRECISION, "conv_general_dilated"),
    # FP32
    "exp": (FP32, "exp"), "exp2": (FP32, "exp2"), "expm1": (FP32, "expm1"),
    "log": (FP32, "log"), "log1p": (FP32, "log1p"), "log2": (FP32, "log"),
    "log10": (FP32, "log"),
    "pow": (FP32, "pow"), "__pow__": (FP32, "pow"),
    "__rpow__": (FP32, "pow"), "float_power": (FP32, "pow"),
    "sqrt": (FP32, "sqrt"), "rsqrt": (FP32, "rsqrt"),
    "sinh": (FP32, "sinh"), "cosh": (FP32, "cosh"), "tanh": (FP32, "tanh"),
    "tan": (FP32, "tan"), "asin": (FP32, "asin"), "acos": (FP32, "acos"),
    "atan": (FP32, "atan"), "atan2": (FP32, "atan2"),
    "asinh": (FP32, "asinh"), "acosh": (FP32, "acosh"),
    "atanh": (FP32, "atanh"),
    "erf": (FP32, "erf"), "erfc": (FP32, "erfc"), "erfinv": (FP32, "erf_inv"),
    "lgamma": (FP32, "lgamma"), "digamma": (FP32, "digamma"),
    "sigmoid": (FP32, "logistic"), "logit": (FP32, "log"),
    "silu": (FP32, "logistic"), "gelu": (FP32, "tanh"),
    "softplus": (FP32, "log1p"),
    "softmax": (FP32, "exp"), "log_softmax": (FP32, "exp"),
    "logsumexp": (FP32, "exp"),
    "cumsum": (FP32, "cumsum"), "cumprod": (FP32, "cumprod"),
    "logcumsumexp": (FP32, "cumlogsumexp"),
    "prod": (FP32, "reduce_prod"),
    "std": (FP32, "sqrt"), "norm": (FP32, "sqrt"),
    "vector_norm": (FP32, "sqrt"),
    "div": (FP32, "div"), "true_divide": (FP32, "div"),
    "__truediv__": (FP32, "div"), "__rtruediv__": (FP32, "div"),
    "__rdiv__": (FP32, "div"), "__div__": (FP32, "div"),
    "reciprocal": (FP32, "div"),
    # reduce_sum inside, the result back in the input's dtype
    "sum": (FP32_ACCUMULATE, "reduce_sum"),
    "nansum": (FP32_ACCUMULATE, "reduce_sum"),
    "mean": (FP32_ACCUMULATE, "reduce_sum"),
    "nanmean": (FP32_ACCUMULATE, "reduce_sum"),
    "var": (FP32_ACCUMULATE, "reduce_sum"),
}

_NAMESPACES = (torch, torch.Tensor, torch._C.TensorBase, F, torch.special,
               torch.linalg)


def _build_table():
    table = {}
    for name, (cls, _) in _BY_NAME.items():
        for ns in _NAMESPACES:
            fn = getattr(ns, name, None)
            if fn is not None:
                try:
                    table[fn] = cls
                except TypeError:        # an unhashable attribute
                    pass
    return table


# torch function or Tensor method -> LOW_PRECISION, FP32 or
# FP32_ACCUMULATE; a function not in the table is PROMOTE
TORCH_FUNCTION_CLASSES = _build_table()

