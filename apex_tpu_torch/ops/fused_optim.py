"""The per-leaf optimizer steps and LAMB phase 1: CUDA kernels and their
plain versions.

Port of three bodies of ``apex_tpu/ops/fused_optim.py`` (row 19 of the
kernel table), each run there by ``_elementwise_call``:

* ``sgd_step`` (:393, body ``_sgd_step_kernel`` :368) and ``adam_step``
  (:220, body ``_adam_step_kernel`` :196): the single-pass steps the
  staged amp route runs once per leaf — over the gradient ``g`` (bf16,
  fp16 or fp32), the fp32 master ``p`` and the optimizer's fp32 state,
  the update in fp32, the new ``p`` and state written in place and, when
  the model keeps a low-precision copy, ``lowp`` cast from the new
  ``p`` in the same pass (the amp O2/O5 writeback).  JAX's
  ``flatten_for_kernel`` LANE padding has no counterpart: the kernels
  take any length;
* ``lamb_phase1`` (:262-305, body ``_lamb_phase1_kernel``): over one flat
  group —
  gradient ``g`` in the model's dtype, fp32 master ``p`` and moments
  ``m``, ``v`` — in fp32::

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

On CUDA tensors :func:`sgd_step` launches ``csrc/fused_sgd.cu``,
:func:`adam_step` the step kernel of ``csrc/fused_adam.cu`` and
:func:`lamb_phase1` ``csrc/fused_lamb.cu``, or they raise; on CPU
tensors they run their plain versions.  The step kernels round every
operation in the plain versions' order (no FMA), so on the card the two
agree bit for bit;
their hyperparameters are rounded to fp32 once, on the host, as the JAX
kernels' fp32 hyperparameter vector holds them (``1 - dampening``,
``1 - beta`` included).  ``grad_scale`` may be a Python number or a 0-d
fp32 tensor on the buffers' device: the LAMB kernel reads it from device
memory, so a scale computed on the device (the clip factor under a
static loss scale) never makes the host wait.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import _build
from ._counts import bump

__all__ = ["lamb_phase1", "lamb_phase1_reference", "sgd_step",
           "sgd_step_reference", "adam_step", "adam_step_reference"]

_G_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_LOWP_TAKES = (torch.bfloat16, torch.float16)

Scalar = Union[float, torch.Tensor]


def _scalar(x: Scalar, device) -> torch.Tensor:
    """An fp32 0-d tensor on ``device``: a Python number (or bool) is
    filled there (no host copy); a tensor is converted only if it must
    be."""
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
    check_buffers("lamb_phase1", g, (p, m, v))
    n = p.numel()
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


# --- the per-leaf steps ---------------------------------------------------

def f32(x) -> float:
    """``x`` rounded to fp32 (the JAX kernels' hyperparameter vector)."""
    return float(np.float32(x))


def one_minus(x) -> float:
    """``1 - x`` formed in fp32, as the JAX kernels form it."""
    return float(np.float32(1.0) - np.float32(x))


def check_buffers(what: str, g, state, lowp=None) -> None:
    """Raise unless ``state`` (the master first) are contiguous fp32
    buffers of one length on one device, ``g`` a contiguous gradient of
    that length in a dtype the kernels take, and ``lowp`` None or a
    contiguous bf16/fp16 buffer of that length: what the element-wise
    kernels read as flat arrays."""
    p = state[0]
    n = p.numel()
    for t in state:
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.numel() != n or t.device != p.device:
            raise ValueError(f"{what}: the master and state must be "
                             f"contiguous float32 buffers of {n} elements "
                             f"on {p.device}")
    if g.dtype not in _G_TAKES or not g.is_contiguous() or \
            g.numel() != n or g.device != p.device:
        raise ValueError(f"{what}: g must be a contiguous {_G_TAKES} "
                         f"buffer of {n} elements on {p.device}")
    if lowp is not None and (lowp.dtype not in _LOWP_TAKES
                             or not lowp.is_contiguous()
                             or lowp.numel() != n
                             or lowp.device != p.device):
        raise ValueError(f"{what}: lowp must be a contiguous {_LOWP_TAKES} "
                         f"buffer of {n} elements on {p.device}")


def sgd_step_reference(g, p, mom, lowp=None, *, lr, momentum, dampening,
                       weight_decay, nesterov=False, wd_after_momentum=False,
                       first_run):
    """Plain version of the SGD step (the ``_sgd_step_kernel`` math, in
    its order, one rounding an operation), updating ``p``, ``mom`` and
    ``lowp`` in place; returns them."""
    lr_, mo, omd, wd = (_scalar(x, p.device) for x in (
        f32(lr), f32(momentum), one_minus(dampening), f32(weight_decay)))
    gf = g.float()
    if not wd_after_momentum:
        gf = gf + wd * p
    mom_new = gf if first_run else mo * mom + omd * gf
    upd = gf + mo * mom_new if nesterov else mom_new
    if wd_after_momentum:
        upd = upd + wd * p
    p.copy_(p - lr_ * upd)
    mom.copy_(mom_new)
    if lowp is not None:
        lowp.copy_(p)
    return p, mom, lowp


def sgd_step(g: torch.Tensor, p: torch.Tensor, mom: torch.Tensor,
             lowp: Optional[torch.Tensor] = None, *, lr: float,
             momentum: float, dampening: float, weight_decay: float,
             nesterov: bool = False, wd_after_momentum: bool = False,
             first_run: bool):
    """One momentum-SGD step over one leaf, in place: ``p`` and ``mom``
    updated, the model copy cast into ``lowp`` (None when the master is
    the model copy).  ``first_run``: torch's first step, ``mom <- g``.
    Returns ``(p, mom, lowp)``."""
    kw = dict(lr=lr, momentum=momentum, dampening=dampening,
              weight_decay=weight_decay, nesterov=nesterov,
              wd_after_momentum=wd_after_momentum, first_run=first_run)
    if p.device.type == "cpu":
        return sgd_step_reference(g, p, mom, lowp, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"sgd_step runs on cuda or cpu, not {p.device}")
    check_buffers("sgd_step", g, (p, mom), lowp)
    lib = _build.library("fused_sgd")
    with torch.cuda.device(p.device):
        rc = lib.apex_sgd_step(
            g.data_ptr(), p.data_ptr(), mom.data_ptr(),
            None if lowp is None else lowp.data_ptr(), p.numel(), f32(lr),
            f32(momentum), one_minus(dampening), f32(weight_decay),
            int(bool(first_run)), int(bool(nesterov)),
            int(bool(wd_after_momentum)), _build.dtype_code(g.dtype),
            _build.dtype_code(lowp.dtype) if lowp is not None else 0,
            _build.stream_ptr(p.device))
    _build.check("fused_sgd", rc, "sgd_step kernel")
    bump("sgd_step")
    return p, mom, lowp


def adam_step_reference(g, p, m, v, lowp=None, *, lr, beta1, beta2, eps,
                        weight_decay, bias_correction1, bias_correction2,
                        adam_w_mode=True):
    """Plain version of the Adam step (the ``_adam_step_kernel`` math, in
    its order, one rounding an operation), updating ``p``, ``m``, ``v``
    and ``lowp`` in place; returns them."""
    lr_, b1, omb1, b2, omb2, eps_, wd, bc1, bc2 = (
        _scalar(x, p.device) for x in (
            f32(lr), f32(beta1), one_minus(beta1), f32(beta2),
            one_minus(beta2), f32(eps), f32(weight_decay),
            f32(bias_correction1), f32(bias_correction2)))
    gf = g.float()
    if not adam_w_mode:
        gf = gf + wd * p
    m_new = b1 * m + omb1 * gf
    v_new = b2 * v + omb2 * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps_)
    if adam_w_mode:
        upd = upd + wd * p
    p.copy_(p - lr_ * upd)
    m.copy_(m_new)
    v.copy_(v_new)
    if lowp is not None:
        lowp.copy_(p)
    return p, m, v, lowp


def adam_step(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, lowp: Optional[torch.Tensor] = None, *,
              lr: float, beta1: float, beta2: float, eps: float,
              weight_decay: float, bias_correction1: float,
              bias_correction2: float, adam_w_mode: bool = True):
    """One Adam (``adam_w_mode=False``: L2) or AdamW step over one leaf,
    in place: ``p``, ``m``, ``v`` updated, the model copy cast into
    ``lowp`` (None when the master is the model copy).  Returns ``(p, m,
    v, lowp)``."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, bias_correction1=bias_correction1,
              bias_correction2=bias_correction2, adam_w_mode=adam_w_mode)
    if p.device.type == "cpu":
        return adam_step_reference(g, p, m, v, lowp, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"adam_step runs on cuda or cpu, not {p.device}")
    check_buffers("adam_step", g, (p, m, v), lowp)
    lib = _build.library("fused_adam")
    with torch.cuda.device(p.device):
        rc = lib.apex_adam_step(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if lowp is None else lowp.data_ptr(), p.numel(), f32(lr),
            f32(beta1), one_minus(beta1), f32(beta2), one_minus(beta2),
            f32(eps), f32(weight_decay), f32(bias_correction1),
            f32(bias_correction2), int(bool(adam_w_mode)),
            _build.dtype_code(g.dtype),
            _build.dtype_code(lowp.dtype) if lowp is not None else 0,
            _build.stream_ptr(p.device))
    _build.check("fused_adam", rc, "adam_step kernel")
    bump("adam_step")
    return p, m, v, lowp
