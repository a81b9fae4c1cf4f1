"""LayerNorm forward and backward: the CUDA kernels and their plain
PyTorch versions.

Port of ``apex_tpu/ops/layer_norm.py`` (``layer_norm``, its custom VJP,
and the Pallas ``_ln_forward`` / ``_ln_backward``).  Statistics are fp32
whatever x's dtype; gamma/beta may be fp32 over bf16/fp16 x (the mixed
variant) or in x's dtype (the O5 cast); the output has x's dtype.  The
forward kernel also returns the fp32 per-row mean and rstd, which the
backward reads.  The backward returns dx in x's dtype and dgamma/dbeta
summed in fp32 and cast once to gamma's dtype, as ``_ln_backward``
does.

On a CUDA tensor :func:`layer_norm_with_stats` and
:func:`layer_norm_backward` launch ``csrc/layer_norm.cu`` or raise; on a
CPU tensor they run :func:`layer_norm_stats_reference` and
:func:`layer_norm_backward_reference`.  :class:`FusedLayerNormFunction`
pairs them under autograd (:func:`fused_layer_norm`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["layer_norm", "layer_norm_with_stats", "layer_norm_reference",
           "layer_norm_stats_reference", "layer_norm_backward",
           "layer_norm_backward_reference", "FusedLayerNormFunction",
           "fused_layer_norm"]

_MAX_HIDDEN = 8192           # hidden * 4 bytes of shared memory per row
_TAKES = (torch.float32, torch.bfloat16, torch.float16)


def layer_norm_stats_reference(x, gamma, beta, eps: float = 1e-5):
    """Plain version of the kernel: ``(y, mean, rstd)`` with mean/rstd
    fp32 of shape ``x.shape[:-1]``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    if gamma is not None:
        y = y * gamma.float() + beta.float()
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm_reference(x, gamma, beta, eps: float = 1e-5):
    """The jnp twin's math (``_layer_norm_reference``): fp32
    statistics, mixed-dtype affine, output in x's dtype."""
    return layer_norm_stats_reference(x, gamma, beta, eps)[0]


def layer_norm_backward_reference(x, gamma, dy, mean, rstd):
    """Plain version of the backward kernel (the math of
    ``_ln_bwd_kernel`` and the sum of its partials): ``(dx, dgamma,
    dbeta)`` from the forward's fp32 ``mean``/``rstd`` (shape
    ``x.shape[:-1]``); dgamma/dbeta are None without gamma."""
    xf = x.float()
    dyf = dy.float()
    xhat = (xf - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)
    gdy = dyf * gamma.float() if gamma is not None else dyf
    m1 = gdy.mean(dim=-1, keepdim=True)
    m2 = (gdy * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd.unsqueeze(-1) * (gdy - m1 - xhat * m2)).to(x.dtype)
    if gamma is None:
        return dx, None, None
    hidden = x.shape[-1]
    dgamma = (dyf * xhat).reshape(-1, hidden).sum(0).to(gamma.dtype)
    dbeta = dyf.reshape(-1, hidden).sum(0).to(gamma.dtype)
    return dx, dgamma, dbeta


def _check(x, gamma, beta, what):
    hidden = x.shape[-1]
    if x.dtype not in _TAKES:
        raise TypeError(f"{what} kernel takes {_TAKES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous x")
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"{what} kernel takes hidden <= "
                         f"{_MAX_HIDDEN}, got {hidden}")
    if (gamma is None) != (beta is None):
        raise ValueError("pass both gamma and beta or neither")
    if gamma is not None:
        for name, w in (("gamma", gamma), ("beta", beta)):
            if w.shape != (hidden,) or not w.is_contiguous():
                raise ValueError(f"{name} must be contiguous ({hidden},), "
                                 f"got {tuple(w.shape)}")
            if w.device != x.device:
                raise ValueError(f"{name} is on {w.device}, x on "
                                 f"{x.device}")
            if w.dtype not in (x.dtype, torch.float32):
                raise TypeError(f"{name} dtype {w.dtype} must be "
                                f"float32 or x's {x.dtype}")
        if gamma.dtype != beta.dtype:
            raise TypeError("gamma and beta dtypes differ")


def _launch(x, gamma, beta, eps):
    _check(x, gamma, beta, "layer_norm")
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        rc = lib.apex_layer_norm_fwd(
            x.data_ptr(), None if gamma is None else gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
            _build.dtype_code(x.dtype),
            _build.dtype_code(gamma.dtype if gamma is not None
                              else x.dtype),
            _build.stream_ptr(x.device))
    _build.check("layer_norm", rc, "layer_norm kernel")
    bump("layer_norm")
    return y, mean, rstd


def layer_norm_with_stats(x: torch.Tensor, gamma: Optional[torch.Tensor],
                          beta: Optional[torch.Tensor], eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(y, mean, rstd)`` over the last dimension — the kernel's full
    output (mean/rstd fp32, shape ``x.shape[:-1]``)."""
    if x.device.type == "cpu":
        return layer_norm_stats_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, gamma, beta, eps)


def layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
               beta: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """Fused layer norm over the last dimension, forward only (no
    autograd: :func:`fused_layer_norm` is the differentiable form)."""
    return layer_norm_with_stats(x, gamma, beta, eps)[0]


def _launch_backward(x, gamma, dy, mean, rstd):
    _check(x, gamma, gamma, "layer_norm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            not dy.is_contiguous() or dy.device != x.device:
        raise ValueError(f"dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != x.shape[:-1] or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{tuple(x.shape[:-1])} on {x.device}")
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    dx = torch.empty_like(x)
    if gamma is None:
        dgamma = dbeta = None
    else:
        dgamma = torch.empty_like(gamma)
        dbeta = torch.empty_like(gamma)
    if rows == 0:
        if gamma is not None:
            dgamma.zero_()
            dbeta.zero_()
        return dx, dgamma, dbeta
    # row-walking blocks: four per SM fill the card, each leaves one
    # fp32 partial row of dgamma and of dbeta
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    parts = min(rows, 4 * sms)
    if gamma is not None:
        part = torch.empty((2, parts, hidden), dtype=torch.float32,
                           device=x.device)
        ptrs = (part[0].data_ptr(), part[1].data_ptr(), dgamma.data_ptr(),
                dbeta.data_ptr())
    else:
        ptrs = (None, None, None, None)
    lib = _build.library("layer_norm")
    with torch.cuda.device(x.device):
        rc = lib.apex_layer_norm_bwd(
            x.data_ptr(), None if gamma is None else gamma.data_ptr(),
            dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            *ptrs, rows, hidden, parts, _build.dtype_code(x.dtype),
            _build.dtype_code(gamma.dtype if gamma is not None
                              else x.dtype),
            _build.stream_ptr(x.device))
    _build.check("layer_norm", rc, "layer_norm_bwd kernel")
    bump("layer_norm_bwd")
    return dx, dgamma, dbeta


def layer_norm_backward(x: torch.Tensor, gamma: Optional[torch.Tensor],
                        dy: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor):
    """``(dx, dgamma, dbeta)`` of the layer norm over the last
    dimension, from the forward's fp32 ``mean``/``rstd``; dgamma/dbeta
    are None without gamma."""
    if x.device.type == "cpu":
        return layer_norm_backward_reference(x, gamma, dy, mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_backward runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_backward(x, gamma, dy.contiguous(), mean, rstd)


class FusedLayerNormFunction(torch.autograd.Function):
    """The layer norm under autograd: the forward kernel, saving x,
    gamma, mean and rstd, and the backward kernel (the JAX package's
    custom VJP, ``apex_tpu/ops/layer_norm.py:176-200``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_with_stats(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_backward(x, gamma, dy, mean, rstd)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x: torch.Tensor, gamma: Optional[torch.Tensor],
                     beta: Optional[torch.Tensor],
                     eps: float = 1e-5) -> torch.Tensor:
    """Differentiable fused layer norm over the last dimension: the
    kernels on CUDA tensors, their plain versions on CPU tensors."""
    return FusedLayerNormFunction.apply(x.contiguous(), gamma, beta, eps)
