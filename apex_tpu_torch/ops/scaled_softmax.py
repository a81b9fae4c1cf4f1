"""Causal and padding-mask scaled softmax forwards and the softmax
backward: the CUDA kernels and their plain PyTorch versions.

Port of ``apex_tpu/ops/scaled_softmax.py:25-216``
(``scaled_upper_triang_masked_softmax`` and ``scaled_masked_softmax``,
their custom VJPs, and the Pallas ``_causal_fwd``, ``_masked_fwd`` and
``_softmax_backward``).  Over (..., sq, sk) attention
scores the forward computes ``softmax(scale * x)`` along the last
dimension with column c kept only where c <= the row's query index;
masked entries are exactly 0.  Math is fp32 whatever x's dtype, and y
has x's dtype.  The backward takes the saved y: ``dx = scale * y * (dy -
sum(y * dy))`` per row, in y's dtype.

The padding-mask forward (row 5 of the kernel table) takes (b, np, sq,
sk) scores and a (b, 1, sq, sk) mask, nonzero = masked, shared by the np
heads: masked entries are filled with the finite -1e30 before the max,
so a fully masked row comes out uniform, 1/sk (never NaN), as the JAX
kernel's does.  (The jnp twin and the unfused path fill -10000, which
gives the same uniform row.)

On a CUDA tensor :func:`causal_softmax`, :func:`masked_softmax` and
:func:`softmax_backward` launch ``csrc/scaled_softmax.cu`` or raise; on
a CPU tensor they run :func:`causal_softmax_reference`,
:func:`masked_softmax_reference` and :func:`softmax_backward_reference`.
:class:`ScaledUpperTriangMaskedSoftmax` and :class:`ScaledMaskedSoftmax`
pair each forward with the backward under autograd
(:func:`scaled_upper_triang_masked_softmax`,
:func:`scaled_masked_softmax`).
"""
from __future__ import annotations

import torch

from .. import _build
from .._autocast_ctx import opaque
from ._counts import bump

__all__ = ["scaled_upper_triang_masked_softmax", "causal_softmax",
           "causal_softmax_reference", "softmax_backward",
           "softmax_backward_reference", "ScaledUpperTriangMaskedSoftmax",
           "scaled_masked_softmax", "masked_softmax",
           "masked_softmax_reference", "ScaledMaskedSoftmax"]

_NEG = -1e30                 # the JAX kernel's fill for masked scores
_TAKES = (torch.float32, torch.bfloat16, torch.float16)


def causal_softmax_reference(x: torch.Tensor, scale: float = 1.0
                             ) -> torch.Tensor:
    """Plain version of the forward kernel (the ``_causal_fwd_kernel``
    math): fp32 ``scale * x``, columns past the row's index set to
    -1e30, max-subtracted exp over the row sum; y in x's dtype."""
    sq, sk = x.shape[-2:]
    s = x.float() * scale
    keep = torch.ones(sq, sk, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~keep, _NEG)
    e = (s - s.amax(dim=-1, keepdim=True)).exp()
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_backward_reference(y: torch.Tensor, dy: torch.Tensor,
                               scale: float = 1.0) -> torch.Tensor:
    """Plain version of the backward kernel (``_softmax_bwd_kernel``):
    ``scale * y * (dy - sum(y * dy))`` per row in fp32, dx in y's
    dtype."""
    yf, dyf = y.float(), dy.float()
    s = (yf * dyf).sum(dim=-1, keepdim=True)
    return (scale * yf * (dyf - s)).to(y.dtype)


def masked_softmax_reference(x: torch.Tensor, mask: torch.Tensor,
                             scale: float = 1.0) -> torch.Tensor:
    """Plain version of the padding-mask kernel (the
    ``_masked_fwd_kernel`` math): fp32 ``scale * x``, entries where the
    (b, 1, sq, sk) mask is nonzero set to -1e30, max-subtracted exp over
    the row sum; y in x's dtype."""
    s = x.float() * scale
    s = s.masked_fill(mask.bool(), _NEG)
    e = (s - s.amax(dim=-1, keepdim=True)).exp()
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def _check(t, what):
    if t.dtype not in _TAKES:
        raise TypeError(f"{what} kernel takes {_TAKES}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous input")
    if t.dim() < 2:
        raise ValueError(f"{what} kernel takes (..., sq, sk), got "
                         f"{tuple(t.shape)}")


def _launch(x, scale):
    _check(x, "causal_softmax")
    sq, sk = x.shape[-2:]
    y = torch.empty_like(x)
    lib = _build.library("scaled_softmax")
    with torch.cuda.device(x.device):
        rc = lib.apex_causal_softmax_fwd(
            x.data_ptr(), y.data_ptr(), x.numel() // max(sk, 1), sq, sk,
            float(scale), _build.dtype_code(x.dtype),
            _build.stream_ptr(x.device))
    _build.check("scaled_softmax", rc, "causal_softmax kernel")
    bump("scaled_softmax_causal_fwd")
    return y


def _launch_masked(x, mask, scale):
    _check(x, "masked_softmax")
    if x.dim() != 4:
        raise ValueError(f"masked_softmax kernel takes (b, np, sq, sk), got "
                         f"{tuple(x.shape)}")
    b, np_, sq, sk = x.shape
    if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[0] not in (1, b) \
            or tuple(mask.shape[2:]) != (sq, sk):
        raise ValueError(f"mask must be (b or 1, 1, sq, sk) = ({b}, 1, {sq}, "
                         f"{sk}), got {tuple(mask.shape)}")
    if mask.device != x.device:
        raise ValueError(f"mask is on {mask.device}, x on {x.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        mask = mask != 0
    if not mask[0, 0].is_contiguous():
        mask = mask.contiguous()
    mask_sb = mask.stride(0) if mask.shape[0] == b and b > 1 else 0
    y = torch.empty_like(x)
    lib = _build.library("scaled_softmax")
    with torch.cuda.device(x.device):
        rc = lib.apex_masked_softmax_fwd(
            x.data_ptr(), mask.data_ptr(), y.data_ptr(), b, np_, sq, sk,
            mask_sb, float(scale), _build.dtype_code(x.dtype),
            _build.stream_ptr(x.device))
    _build.check("scaled_softmax", rc, "masked_softmax kernel")
    bump("scaled_masked_softmax_fwd")
    return y


def _launch_backward(y, dy, scale):
    _check(y, "softmax_backward")
    if dy.shape != y.shape or dy.dtype != y.dtype or \
            not dy.is_contiguous() or dy.device != y.device:
        raise ValueError(f"dy must be a contiguous {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}")
    sk = y.shape[-1]
    dx = torch.empty_like(y)
    lib = _build.library("scaled_softmax")
    with torch.cuda.device(y.device):
        rc = lib.apex_softmax_bwd(
            y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            y.numel() // max(sk, 1), sk, float(scale),
            _build.dtype_code(y.dtype), _build.stream_ptr(y.device))
    _build.check("scaled_softmax", rc, "softmax_backward kernel")
    bump("scaled_softmax_bwd")
    return dx


def causal_softmax(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """The causal softmax over (..., sq, sk), forward only (no autograd:
    :func:`scaled_upper_triang_masked_softmax` is the differentiable
    form)."""
    if x.device.type == "cpu":
        return causal_softmax_reference(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"causal_softmax runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, scale)


def masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                   scale: float = 1.0) -> torch.Tensor:
    """The padding-mask softmax over (b, np, sq, sk) with a (b, 1, sq,
    sk) mask (nonzero = masked), forward only (no autograd:
    :func:`scaled_masked_softmax` is the differentiable form)."""
    if x.device.type == "cpu":
        return masked_softmax_reference(x, mask, scale)
    if x.device.type != "cuda":
        raise ValueError(f"masked_softmax runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_masked(x, mask, scale)


def softmax_backward(y: torch.Tensor, dy: torch.Tensor,
                     scale: float = 1.0) -> torch.Tensor:
    """dx of the scaled softmax from its output ``y`` and ``dy``."""
    if y.device.type == "cpu":
        return softmax_backward_reference(y, dy, scale)
    if y.device.type != "cuda":
        raise ValueError(f"softmax_backward runs on cuda or cpu, not "
                         f"{y.device}")
    return _launch_backward(y, dy.to(y.dtype).contiguous(), scale)


class ScaledUpperTriangMaskedSoftmax(torch.autograd.Function):
    """The causal softmax under autograd: the forward kernel, saving y,
    and the backward kernel on it (the JAX package's custom VJP,
    ``apex_tpu/ops/scaled_softmax.py:57-61, 111-143``).  ``kernels``
    False runs the two plain versions on any device (the oracle
    configuration)."""

    @staticmethod
    def forward(ctx, x, scale, kernels):
        y = causal_softmax(x, scale) if kernels else \
            causal_softmax_reference(x, scale)
        ctx.save_for_backward(y)
        ctx.scale, ctx.kernels = scale, kernels
        return y

    @staticmethod
    def backward(ctx, dy):
        y, = ctx.saved_tensors
        bwd = softmax_backward if ctx.kernels else softmax_backward_reference
        return bwd(y, dy, ctx.scale), None, None


@opaque
def scaled_upper_triang_masked_softmax(x: torch.Tensor, scale: float = 1.0,
                                       *, kernels: bool = True
                                       ) -> torch.Tensor:
    """Differentiable causal softmax over (..., sq, sk) attention scores
    (ref: ``apex_tpu/ops/scaled_softmax.py:75``): the kernels on CUDA
    tensors, their plain versions on CPU tensors or with ``kernels``
    False."""
    return ScaledUpperTriangMaskedSoftmax.apply(x.contiguous(), float(scale),
                                                bool(kernels))


class ScaledMaskedSoftmax(torch.autograd.Function):
    """The padding-mask softmax under autograd: the row-5 forward kernel,
    saving y, and the row-4 backward kernel on it (the JAX package's
    ``_scaled_masked_softmax_fused`` custom VJP,
    ``apex_tpu/ops/scaled_softmax.py:164-216``); the mask takes no
    gradient.  ``kernels`` False runs the plain versions on any device
    (the oracle configuration)."""

    @staticmethod
    def forward(ctx, x, mask, scale, kernels):
        y = masked_softmax(x, mask, scale) if kernels else \
            masked_softmax_reference(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale, ctx.kernels = scale, kernels
        return y

    @staticmethod
    def backward(ctx, dy):
        y, = ctx.saved_tensors
        bwd = softmax_backward if ctx.kernels else softmax_backward_reference
        return bwd(y, dy, ctx.scale), None, None, None


@opaque
def scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                          scale: float = 1.0, *, kernels: bool = True
                          ) -> torch.Tensor:
    """Differentiable softmax over (b, np, sq, sk) scores with a (b, 1,
    sq, sk) padding mask, nonzero = masked (ref:
    ``apex_tpu/ops/scaled_softmax.py:169``): the kernels on CUDA
    tensors, their plain versions on CPU tensors or with ``kernels``
    False."""
    return ScaledMaskedSoftmax.apply(x.contiguous(), mask, float(scale),
                                     bool(kernels))
