"""LAMB phase 1 over flat buffers: the CUDA kernel and its plain version.

Port of ``apex_tpu/ops/fused_optim.py:262-305`` (``lamb_phase1`` and its
Pallas body ``_lamb_phase1_kernel``, run by ``_elementwise_call``; the
LAMB body of row 19 of the kernel table).  Over one flat group —
gradient ``g`` in the model's dtype, fp32 master ``p`` and moments ``m``,
``v`` — it computes, in fp32::

    g = g * grad_scale                 (+ weight_decay * p in L2 mode)
    m = beta1 * m + beta3 * g
    v = beta2 * v + (1 - beta2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps)   (+ weight_decay * p, AdamW)

``grad_scale`` is amp's inverse loss scale times the global-norm clip
factor, folded into one multiplier as the JAX kernel takes it.  The
port updates ``m`` and ``v`` in place (the JAX kernel returns new
arrays) and writes ``u`` into a new fp32 buffer; ``p`` is only read.
The per-tensor trust ratio (phase 2) is
:mod:`apex_tpu_torch.optimizers.fused_lamb`'s, in plain torch.

On CUDA buffers :func:`lamb_phase1` launches ``csrc/fused_lamb.cu`` or
raises; on CPU buffers it runs :func:`lamb_phase1_reference`.
``grad_scale`` may be a Python number or a 0-d fp32 tensor on the
buffers' device: the kernel reads it from device memory, so a scale
computed on the device (the clip factor under a static loss scale)
never makes the host wait.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from .. import _build
from ._counts import bump

__all__ = ["lamb_phase1", "lamb_phase1_reference"]

_G_TAKES = (torch.float32, torch.bfloat16, torch.float16)

Scalar = Union[float, torch.Tensor]


def _scalar(x: Scalar, device) -> torch.Tensor:
    """An fp32 0-d tensor on ``device``: a Python number is filled there
    (no host copy); a tensor is converted only if it must be."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), x, dtype=torch.float32, device=device)


def lamb_phase1_reference(g, p, m, v, *, grad_scale: Scalar, beta1, beta2,
                          beta3, eps, weight_decay, bias_correction1,
                          bias_correction2, adam_w_mode: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version of the kernel (the ``_lamb_phase1_kernel`` math):
    returns ``(u, m, v)``, ``m`` and ``v`` updated in place.  Scalars are
    fp32, as the JAX kernel's hyperparameter vector."""
    def c(x):
        return _scalar(x, p.device)

    b1, b2, b3, eps_, wd = c(beta1), c(beta2), c(beta3), c(eps), \
        c(weight_decay)
    bc1, bc2, gs = c(bias_correction1), c(bias_correction2), c(grad_scale)
    gf = g.float() * gs
    if not adam_w_mode:
        gf = gf + wd * p
    m.copy_(b1 * m + b3 * gf)
    v.copy_(b2 * v + (1.0 - b2) * gf * gf)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps_)
    if adam_w_mode:
        u = u + wd * p
    return u, m, v


def _launch(g, p, m, v, gscale, hyp, adam_w_mode):
    n = p.numel()
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.numel() != n or t.device != p.device:
            raise ValueError(f"{name} must be a contiguous float32 buffer "
                             f"of {n} elements on {p.device}")
    if g.dtype not in _G_TAKES or not g.is_contiguous() or \
            g.numel() != n or g.device != p.device:
        raise ValueError(f"g must be a contiguous {_G_TAKES} buffer of "
                         f"{n} elements on {p.device}")
    u = torch.empty_like(p)
    lib = _build.library("fused_lamb")
    with torch.cuda.device(p.device):
        rc = lib.apex_lamb_phase1(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            u.data_ptr(), gscale.data_ptr(), n, *(float(x) for x in hyp),
            int(bool(adam_w_mode)), _build.dtype_code(g.dtype),
            _build.stream_ptr(p.device))
    _build.check("fused_lamb", rc, "lamb_phase1 kernel")
    bump("lamb_phase1")
    return u


def lamb_phase1(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, grad_scale: Scalar, beta1: float,
                beta2: float, beta3: float, eps: float, weight_decay: float,
                bias_correction1: float, bias_correction2: float,
                adam_w_mode: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LAMB stage 1 over one flat group -> ``(u, m, v)``: ``u`` a new
    fp32 buffer, ``m`` and ``v`` updated in place, ``p`` read only."""
    if p.device.type == "cpu":
        return lamb_phase1_reference(
            g, p, m, v, grad_scale=grad_scale, beta1=beta1, beta2=beta2,
            beta3=beta3, eps=eps, weight_decay=weight_decay,
            bias_correction1=bias_correction1,
            bias_correction2=bias_correction2, adam_w_mode=adam_w_mode)
    if p.device.type != "cuda":
        raise ValueError(f"lamb_phase1 runs on cuda or cpu, not {p.device}")
    hyp = (beta1, beta2, beta3, eps, weight_decay, bias_correction1,
           bias_correction2)
    u = _launch(g, p, m, v, _scalar(grad_scale, p.device), hyp, adam_w_mode)
    return u, m, v
