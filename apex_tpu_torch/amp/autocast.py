"""Op-level autocasting: the O1/O4 opt levels as a torch function mode.

Port of ``apex_tpu/amp/autocast.py``.  The JAX package traces the
wrapped function to a jaxpr and re-evaluates it primitive by primitive,
casting inputs by :mod:`apex_tpu_torch.amp.lists`.  PyTorch runs eagerly,
so the port casts at the same granularity as the calls happen: inside
:func:`autocast` a :class:`torch.overrides.TorchFunctionMode` sees every
torch function and ``Tensor`` method the forward calls and casts its
inputs by the function's class (``lists.TORCH_FUNCTION_CLASSES``; a
function not in the table promotes):

- **low precision** (matmul, ``F.linear``, ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``einsum``, convolutions): JAX's rule
  (``apex_tpu/amp/autocast.py:184-197``).  The operands are rounded to
  the compute dtype and the result is **fp32** where they came in fp32,
  because the traced ``dot_general`` of fp32 operands keeps
  ``preferred_element_type=float32`` (in general the result takes the
  incoming operands' promoted dtype, the traced preference).
  On the CPU the rounded operands are upcast and multiplied in fp32 (JAX's
  own CPU realization).  On the card they go to the tensor cores as they
  are, with fp32 sums and an fp32 result (``torch.bmm(...,
  out_dtype=torch.float32)`` under :class:`_MatmulF32`, whose backward
  feeds the cotangent to the tensor cores in the compute dtype, as a
  TPU's default precision takes JAX's transpose, and rounds each operand
  cotangent to it once, as the transpose of the casts does):
  no fp32 GEMM runs, and TF32 stays as the caller set it.  A linear or
  ``addmm`` adds its bias after the product, by the promotion rule, as the
  JAX ``Dense`` does.  A convolution's result is in the compute dtype
  (``lax.conv_general_dilated`` traces no preferred type), from fp32
  sums.  ``einsum`` on the card has no fp32-output low-precision form in
  PyTorch: its products run from the rounded operands with fp32 sums,
  the result rounded once to the compute dtype, then widened (no path of
  the port reaches it).
- **fp32** (transcendentals, powers, division, norms, softmax, GELU, …):
  every floating input cast to fp32 (a Python float beside a
  low-precision tensor first rounded to its dtype, as JAX's weakly typed
  scalars are).  JAX classifies the primitives of ``jnp``'s
  decompositions, so a few of its functions round inside where the
  port's single op does not: ``jax.nn.softmax`` subtracts the row max in
  the input's dtype, ``jnp.linalg.norm`` squares in it, and
  ``jax.nn.gelu`` rounds its constants to it.
- **fp32 accumulate** (``sum``, ``mean``, ``var``): computed on the fp32
  input, the result cast back to the input's dtype, as ``jnp``'s do.
- everything else: the input dtypes; mixed floating operands promoted to
  the widest.  A function that writes into one of its inputs (an
  in-place method, ``out=``, an item or attribute store) is never cast.

The port's fused entries are opaque (``_autocast_ctx.opaque``), as the
JAX interpreter leaves ``custom_vjp`` calls: flash attention casts its
inputs to the compute dtype and layer norm to fp32 at their boundaries,
from :func:`~apex_tpu_torch._autocast_ctx.autocast_compute_dtype`, which
:func:`autocast` sets while the wrapped function runs.

The casts are autograd operations, so the backward (run outside the
region, as ``jax.grad`` of the autocast function transposes its casts)
takes each cotangent back to its input's dtype.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

from .. import _autocast_ctx as _actx
from . import lists
from .policy import Policy

__all__ = ["autocast", "half_function",
           "bfloat16_function", "float_function", "promote_function"]

_LOW, _FP32 = lists.LOW_PRECISION, lists.FP32
_TABLE = lists.TORCH_FUNCTION_CLASSES
_STORES = frozenset({"__setitem__", "__set__", "__delete__", "__delitem__"})
# the attribute :func:`autocast` sets on the tensors its function returns
_TAG = "_amp_autocast_dtype"


def autocast_dtype_of(t: torch.Tensor) -> Optional[torch.dtype]:
    """The compute dtype of the :func:`autocast` region that returned
    ``t``, or None if no region returned it (``AmpOptimizer`` reads it to
    refuse a cast_ops loss computed outside autocast)."""
    return getattr(t, _TAG, None)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast(x, dtype):
    return x.to(dtype) if _is_float(x) and x.dtype != dtype else x


def _map(f, tree):
    """``f`` over the tensors of args or kwargs, one list/tuple level
    deep (a ``torch.cat`` list)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return f(x)
        if isinstance(x, (list, tuple)):
            return type(x)(f(y) if isinstance(y, torch.Tensor) else y
                           for y in x)
        return x

    if isinstance(tree, dict):
        return {k: one(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(one(x) for x in tree)
    return one(tree)


def _weak(x, dtype):
    """A Python float rounded to ``dtype``, as a weakly typed JAX scalar
    takes its operand's dtype; anything else as it is."""
    if type(x) is float:
        return torch.tensor(x, dtype=dtype).item()
    return x


def _float_dtypes(args, kwargs):
    seen = set()
    for x in (*args, *kwargs.values()):
        if isinstance(x, (list, tuple)):
            seen.update(y.dtype for y in x if _is_float(y))
        elif _is_float(x):
            seen.add(x.dtype)
    return seen


def _writes(func, kwargs) -> bool:
    name = getattr(func, "__name__", "")
    return ("out" in kwargs or name in _STORES
            or (name.endswith("_") and not name.endswith("__"))
            or (name.startswith("__i") and name.endswith("__")))


# --- the low-precision products ----------------------------------------

def _bmm_f32(a, b):
    """``bmm`` with fp32 sums and an fp32 result (the tensor cores on
    16-bit operands)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a, b, out_dtype=torch.float32)


def _summed(x, y, shape, dtype):
    """The batched product ``x @ y`` summed to ``shape`` over the batch
    dimensions an operand was broadcast along, rounded once to
    ``dtype``."""
    batch = x.shape[:-2]
    x, y = x.reshape(-1, *x.shape[-2:]), y.reshape(-1, *y.shape[-2:])
    if batch == shape[:-2]:
        return torch.bmm(x, y).reshape(shape)
    z = _bmm_f32(x, y).reshape(*batch, x.shape[-2], y.shape[-1])
    return z.sum_to_size(shape).to(dtype)


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two compute-dtype operands of 2 or more dimensions
    (``torch.matmul``'s batch broadcast) with fp32 sums and an fp32
    result on the tensor cores.  The backward takes the fp32 cotangent
    to the operands' dtype, the tensor cores' operand type (JAX's
    transpose multiplies the fp32 cotangent by the 16-bit operand, which
    a TPU's default precision rounds the same way), and rounds each
    operand's cotangent once, after its fp32 sums, those over the batch
    dimensions it was broadcast along included."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        m, k = a.shape[-2:]
        n = b.shape[-1]
        if b.dim() == 2:
            # x @ W: every row of every batch against one matrix
            y = _bmm_f32(a.reshape(1, -1, k), b.unsqueeze(0))
            return y.reshape(*a.shape[:-1], n)
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        y = _bmm_f32(a.expand(*batch, m, k).reshape(-1, m, k),
                     b.expand(*batch, k, n).reshape(-1, k, n))
        return y.reshape(*batch, m, n)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if b.dim() == 2:
            g2 = g.reshape(-1, b.shape[1])
            if ctx.needs_input_grad[0]:
                ga = torch.mm(g2, b.T).reshape(a.shape)
            if ctx.needs_input_grad[1]:
                gb = torch.mm(a.reshape(-1, b.shape[0]).T, g2)
            return ga, gb
        batch = g.shape[:-2]
        if ctx.needs_input_grad[0]:
            bt = b.mT.expand(*batch, b.shape[-1], b.shape[-2])
            ga = _summed(g, bt, a.shape, a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.mT.expand(*batch, a.shape[-1], a.shape[-2])
            gb = _summed(at, g, b.shape, b.dtype)
        return ga, gb


def _cuda_matmul_f32(a, b):
    """``torch.matmul`` semantics (broadcast batch dimensions, 1-D
    operands) over :class:`_MatmulF32`."""
    vec_a, vec_b = a.dim() == 1, b.dim() == 1
    if vec_a:
        a = a.unsqueeze(0)
    if vec_b:
        b = b.unsqueeze(-1)
    out = _MatmulF32.apply(a, b)
    if vec_a:
        out = out.squeeze(-2)
    if vec_b:
        out = out.squeeze(-1)
    return out


def _matmul(a, b, dtype):
    """``a @ b`` from operands rounded to ``dtype`` with fp32 sums; the
    result in the operands' promoted dtype, the traced dot's
    ``preferred_element_type`` (fp32 for fp32 operands)."""
    if not (_is_float(a) and _is_float(b)):
        return torch.matmul(a, b)
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = _cast(a, dtype), _cast(b, dtype)
    if a.device.type == "cuda":
        y = _cuda_matmul_f32(a, b)
    else:
        y = torch.matmul(a.float(), b.float())
    return _cast(y, out_dtype)


def _arg(args, kwargs, i, name, default=None):
    if len(args) > i:
        return args[i]
    return kwargs.get(name, default)


def _bias_shape(bias, ndim):
    # a convolution's (C,) bias against its (N, C, *spatial) output
    return bias.reshape(1, -1, *([1] * (ndim - 2)))


def _low_precision(func, args, kwargs, dtype):
    name = getattr(func, "__name__", "")
    if name == "linear":
        x, w = _arg(args, kwargs, 0, "input"), _arg(args, kwargs, 1, "weight")
        bias = _arg(args, kwargs, 2, "bias")
        y = _matmul(x, w.mT, dtype)
        return y if bias is None else y + bias
    if name in ("matmul", "__matmul__", "mm", "bmm"):
        return _matmul(args[0], _arg(args, kwargs, 1, "other",
                                     kwargs.get("mat2")), dtype)
    if name == "__rmatmul__":
        return _matmul(args[1], args[0], dtype)
    if name in ("addmm", "baddbmm"):
        inp = _arg(args, kwargs, 0, "input")
        m1 = _arg(args, kwargs, 1, "mat1" if name == "addmm" else "batch1")
        m2 = _arg(args, kwargs, 2, "mat2" if name == "addmm" else "batch2")
        beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
        y = _matmul(m1, m2, dtype)
        if alpha != 1:
            y = y * alpha
        return y + (inp if beta == 1 else beta * inp)
    if name == "einsum":
        eq, *ops = args
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = list(ops[0])
        floats = [o.dtype for o in ops if _is_float(o)]
        if not floats:
            return func(eq, *ops)
        out_dtype = functools.reduce(torch.promote_types, floats)
        ops = [_cast(o, dtype) for o in ops]
        if ops[0].device.type == "cuda":
            return _cast(func(eq, *ops), out_dtype)
        return _cast(func(eq, *[_cast(o, torch.float32) for o in ops]),
                     out_dtype)
    if name in ("conv1d", "conv2d", "conv3d"):
        x, w = _arg(args, kwargs, 0, "input"), _arg(args, kwargs, 1, "weight")
        bias = _arg(args, kwargs, 2, "bias")
        rest = {k: v for k, v in kwargs.items()
                if k not in ("input", "weight", "bias")}
        # lax.conv_general_dilated traces no preferred type: the result
        # in the compute dtype, from fp32 sums
        x, w = _cast(x, dtype), _cast(w, dtype)
        if x.device.type == "cuda":
            y = func(x, w, None, *args[3:], **rest)
        else:
            y = _cast(func(x.float(), w.float(), None, *args[3:], **rest),
                      dtype)
        return y if bias is None else y + _bias_shape(bias, y.dim())
    raise NotImplementedError(f"amp.autocast: no low-precision rule for "
                              f"{name}")


class _CastMode(TorchFunctionMode):
    """Casts the inputs of each torch function by its class under the
    lists (see the module docstring)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        cls = _TABLE.get(func)
        writes = _writes(func, kwargs)
        if cls is None or writes:
            if len(args) + len(kwargs) > 1 and not writes:
                dtypes = _float_dtypes(args, kwargs)
                if len(dtypes) > 1:
                    wide = functools.reduce(torch.promote_types, dtypes)
                    args = _map(lambda t: _cast(t, wide), args)
                    kwargs = _map(lambda t: _cast(t, wide), kwargs)
            return func(*args, **kwargs)
        if cls == _LOW:
            return _low_precision(func, args, kwargs, self.dtype)
        if cls == _FP32:
            dtypes = _float_dtypes(args, kwargs)
            if len(dtypes) == 1 and torch.float32 not in dtypes:
                # a Python float meets a low-precision tensor: JAX gives
                # it the tensor's dtype (a weak type) before the cast
                low = dtypes.pop()
                args = tuple(_weak(a, low) for a in args)
                kwargs = {k: _weak(v, low) for k, v in kwargs.items()}
            f32 = functools.partial(_cast, dtype=torch.float32)
            return func(*_map(f32, args), **_map(f32, kwargs))
        # fp32 accumulate: the input's dtype back, unless one is asked for
        x = args[0] if args else kwargs.get("input")
        if not _is_float(x) or x.dtype == torch.float32 or "dtype" in kwargs:
            return func(*args, **kwargs)
        if args:
            out = func(x.float(), *args[1:], **kwargs)
        else:
            out = func(**{**kwargs, "input": x.float()})
        return _map(lambda t: _cast(t, x.dtype), out) \
            if isinstance(out, tuple) else _cast(out, x.dtype)


@contextlib.contextmanager
def _region(dtype: torch.dtype):
    """The casting mode and the compute-dtype context, entered together;
    raises if torch function modes cannot act here (the casts would
    silently not happen)."""
    token = _actx.set_autocast_dtype(dtype)
    try:
        with _CastMode(dtype):
            if not torch._C._is_torch_function_mode_enabled():
                raise RuntimeError("amp.autocast: torch function modes are "
                                   "disabled here, so the O1/O4 casts "
                                   "would not apply")
            yield
    finally:
        _actx.reset_autocast_dtype(token)


def autocast(fn: Optional[Callable] = None, *,
             compute_dtype: torch.dtype = torch.bfloat16,
             policy: Optional[Policy] = None) -> Callable:
    """Wrap ``fn`` so the torch functions it calls run under the O1/O4
    cast lists (O4's bf16 by default; ``compute_dtype=torch.float16`` or
    an O1 policy for fp16)::

        @amp.autocast
        def forward(model, x): ...

        loss = amp.autocast(loss_fn, policy=amp.O4)(model, x)
        loss.backward()

    A policy without ``cast_ops`` (O0, O2, O3, O5) returns ``fn`` itself.
    The tensors the wrapped function returns (as they are, or in a
    tuple, list or dict) carry the compute dtype
    (:func:`autocast_dtype_of`).
    """
    if fn is None:
        return functools.partial(autocast, compute_dtype=compute_dtype,
                                 policy=policy)
    if policy is not None:
        if not policy.cast_ops:
            return fn
        compute_dtype = policy.cast_ops_type

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _region(compute_dtype):
            out = fn(*args, **kwargs)
        for t in (out.values() if isinstance(out, dict) else
                  out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                setattr(t, _TAG, compute_dtype)
        return out

    return wrapped


# --- explicit function registration (ref: apex/amp/amp.py:29-71) -------

def _casting_wrapper(fn, dtype):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        f = functools.partial(_cast, dtype=dtype)
        return fn(*_map(f, args), **_map(f, kwargs))
    return wrapped


def half_function(fn: Callable) -> Callable:
    """Cast a function's floating tensor arguments to fp16."""
    return _casting_wrapper(fn, torch.float16)


def bfloat16_function(fn: Callable) -> Callable:
    """Cast a function's floating tensor arguments to bf16 (the fork's
    ``bfloat16_function``)."""
    return _casting_wrapper(fn, torch.bfloat16)


def float_function(fn: Callable) -> Callable:
    """Cast a function's floating tensor arguments to fp32."""
    return _casting_wrapper(fn, torch.float32)


def promote_function(fn: Callable) -> Callable:
    """Promote a function's floating tensor arguments to the widest of
    their dtypes."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        dtypes = _float_dtypes(args, kwargs)
        if dtypes:
            wide = functools.reduce(torch.promote_types, dtypes)
            f = functools.partial(_cast, dtype=wide)
            args, kwargs = _map(f, args), _map(f, kwargs)
        return fn(*args, **kwargs)
    return wrapped

