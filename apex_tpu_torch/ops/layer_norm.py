"""LayerNorm forward: the CUDA kernel and its plain PyTorch version.

Port of ``apex_tpu/ops/layer_norm.py`` (``layer_norm`` and the Pallas
``_ln_forward``), forward only.  Statistics are fp32 whatever x's
dtype; gamma/beta may be fp32 over bf16/fp16 x (the mixed variant);
the output has x's dtype.  The kernel also returns the fp32 per-row
mean and rstd, as the JAX kernel does, for the backward a later slice
ports.

On a CUDA tensor :func:`layer_norm` launches ``csrc/layer_norm.cu`` or
raises; on a CPU tensor it runs :func:`layer_norm_reference`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["layer_norm", "layer_norm_with_stats", "layer_norm_reference",
           "layer_norm_stats_reference"]

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


def _launch(x, gamma, beta, eps):
    hidden = x.shape[-1]
    if x.dtype not in _TAKES:
        raise TypeError(f"layer_norm kernel takes {_TAKES}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs a contiguous x")
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"layer_norm kernel takes hidden <= "
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
    """Fused layer norm over the last dimension (forward only)."""
    return layer_norm_with_stats(x, gamma, beta, eps)[0]
