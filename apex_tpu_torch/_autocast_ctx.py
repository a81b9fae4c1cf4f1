"""The autocast context shared by ``amp.autocast`` and the fused ops.

Port of ``apex_tpu/_autocast_ctx.py``.  ``amp.autocast`` (O1/O4) casts
the inputs of the torch functions a forward calls by its lists; the
port's fused entries (flash attention, layer norm, the scaled softmax,
the cross entropy, the MoE routing), whose JAX twins are ``custom_vjp``
calls the JAX interpreter leaves opaque, are single ops to it: each runs
with the casting mode suspended inside (:func:`opaque`), and flash
attention and layer norm read :func:`autocast_compute_dtype` to cast
their own inputs at the boundary (flash to the compute dtype, layer norm
to fp32), as the JAX entries do.

The active compute dtype is a :class:`contextvars.ContextVar`.  The JAX
module registers its state in JAX's trace-context key so a function
jitted outside autocast retraces under it; eager PyTorch has no trace
cache, so the variable is read at every call and nothing else is needed.

Lives in its own module so ``apex_tpu_torch.ops`` never imports
``apex_tpu_torch.amp`` (and vice versa) at module level.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Callable, Optional

import torch

__all__ = ["autocast_compute_dtype", "set_autocast_dtype",
           "reset_autocast_dtype", "opaque", "boundary_cast"]

_DTYPE: contextvars.ContextVar[Optional[torch.dtype]] = \
    contextvars.ContextVar("apex_tpu_torch_autocast_dtype", default=None)


def autocast_compute_dtype() -> Optional[torch.dtype]:
    """The active ``amp.autocast`` compute dtype, or None outside one."""
    return _DTYPE.get()


def set_autocast_dtype(dtype: torch.dtype) -> contextvars.Token:
    """Enter a compute dtype; returns the token :func:`reset_autocast_dtype`
    takes."""
    return _DTYPE.set(dtype)


def reset_autocast_dtype(token: contextvars.Token) -> None:
    _DTYPE.reset(token)


def opaque(fn: Callable) -> Callable:
    """Run ``fn`` as one op under ``amp.autocast``: with every torch
    function mode (the casting mode among them) suspended inside, so its
    body and its plain version compute in the dtypes they are given, as
    the JAX interpreter leaves a ``custom_vjp`` body alone.  Outside
    autocast it calls ``fn`` as it is."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _DTYPE.get() is None:
            return fn(*args, **kwargs)
        with torch._C.DisableTorchFunction():
            return fn(*args, **kwargs)
    return wrapped


def boundary_cast(dtype: Optional[torch.dtype], *tensors):
    """``tensors`` with each floating one not already in ``dtype`` cast to
    it (None passes through); ``dtype`` None returns them unchanged."""
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) if t is not None and t.is_floating_point()
                 and t.dtype != dtype else t for t in tensors)
