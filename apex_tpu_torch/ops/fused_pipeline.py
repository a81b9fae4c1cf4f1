"""The persistent packed optimizer pipeline: flat buffers and the Adam
update sweep.

Port of ``apex_tpu/ops/fused_pipeline.py`` (``adam_pipeline`` and its
Pallas body ``_adam_pipeline_kernel`` run by
``fused_optim._elementwise_call``) with the flat layout it needs from
``apex_tpu/ops/multi_tensor.py``.  fp32 masters and the optimizer's
moments live in one flat fp32 buffer per model dtype group across
steps.  In the PyTorch idiom the model's own parameters are views into
one flat buffer per group (:func:`flatten_params`), and so are their
``.grad``: backward accumulates straight into the flat gradient buffer,
and the sweep writes the low-precision model copy straight into the
flat parameter buffer — no per-step pack and no assemble.  The JAX
package's 16M-element chunking (``PACK_MAX_ELEMS``) guards an XLA
layout temporary and is not needed here.

On CUDA tensors :func:`adam_pipeline` launches ``csrc/fused_adam.cu``
or raises; on CPU tensors it runs :func:`adam_pipeline_reference` (the
``_adam_pipeline_jnp`` math).  Both update ``p``, ``m``, ``v`` and
``lowp`` in place.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["FlatGroup", "flatten_params", "adam_pipeline",
           "adam_pipeline_reference"]

_G_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_LOWP_TAKES = (torch.bfloat16, torch.float16)


@dataclasses.dataclass
class FlatGroup:
    """One dtype group of the model's parameters, flattened.

    ``params``: the group's parameters, in model order; ``offsets``
    their start elements; ``data`` the flat model-dtype buffer the
    parameters are views of; ``grad`` the flat buffer their ``.grad``
    are views of; ``master`` the flat fp32 master copy (for an fp32
    group, ``data`` itself)."""

    dtype: torch.dtype
    names: Tuple[str, ...]
    params: Tuple[torch.nn.Parameter, ...]
    offsets: Tuple[int, ...]
    data: torch.Tensor
    grad: torch.Tensor
    master: torch.Tensor

    @property
    def lowp(self) -> Optional[torch.Tensor]:
        """The sweep's model-copy output: the flat parameter buffer, or
        None when the group is fp32 (the master is the model copy)."""
        return None if self.dtype == torch.float32 else self.data

    def master_of(self, i: int) -> torch.Tensor:
        """The fp32 master of parameter ``i``, as a view."""
        p = self.params[i]
        return self.master[self.offsets[i]:self.offsets[i]
                           + p.numel()].view(p.shape)


def flatten_params(named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                   masters: dict) -> List[FlatGroup]:
    """Group ``named_params`` by dtype (first appearance order) and make
    each group's parameters and gradients views into flat buffers.

    ``masters`` maps each name to its fp32 value snapshotted before the
    low-precision cast; a low-precision group's flat fp32 master buffer
    is built from them (an fp32 group's parameters are their own
    masters).  Each parameter's ``.data`` becomes a view of the flat
    model buffer (its values copied in), and its ``.grad`` a zeroed view
    of the flat gradient buffer, which autograd then accumulates into in
    place."""
    groups: dict = {}
    for name, p in named_params:
        groups.setdefault(p.dtype, []).append((name, p))
    out = []
    for dtype, members in groups.items():
        dev = members[0][1].device
        offsets, off = [], 0
        for _, p in members:
            offsets.append(off)
            off += p.numel()
        data = torch.empty(off, dtype=dtype, device=dev)
        grad = torch.zeros(off, dtype=dtype, device=dev)
        master = data if dtype == torch.float32 else \
            torch.empty(off, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for (name, p), o in zip(members, offsets):
                n = p.numel()
                data[o:o + n].copy_(p.detach().reshape(-1))
                if master is not data:
                    master[o:o + n].copy_(masters[name].reshape(-1))
                p.data = data[o:o + n].view(p.shape)
                p.grad = grad[o:o + n].view(p.shape)
        out.append(FlatGroup(dtype, tuple(n for n, _ in members),
                             tuple(p for _, p in members), tuple(offsets),
                             data, grad, master))
    return out


def adam_pipeline_reference(g, p, m, v, lowp=None, *, grad_scale, lr,
                            beta1, beta2, eps, weight_decay,
                            bias_correction1, bias_correction2,
                            adam_w_mode=True, keep=True):
    """Plain version of the sweep (the ``_adam_pipeline_jnp`` math),
    updating ``p``, ``m``, ``v`` (fp32) and ``lowp`` in place.  Scalars
    are computed in fp32, as the JAX kernel's hyperparameter vector."""
    def c(x):   # an fp32 scalar made on the device (no host copy)
        return torch.full((), x, dtype=torch.float32, device=p.device)

    lr, b1, b2, eps_, wd = c(lr), c(beta1), c(beta2), c(eps), \
        c(weight_decay)
    bc1, bc2, gs = c(bias_correction1), c(bias_correction2), c(grad_scale)
    gf = g.float() * gs
    if not adam_w_mode:
        gf = gf + wd * p
    m_new = b1 * m + (1.0 - b1) * gf
    v_new = b2 * v + (1.0 - b2) * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps_)
    if adam_w_mode:
        upd = upd + wd * p
    if keep:
        p.sub_(lr * upd)
        m.copy_(m_new)
        v.copy_(v_new)
    if lowp is not None:
        lowp.copy_(p)
    return p, m, v, lowp


def _launch(g, p, m, v, lowp, hyp, adam_w_mode):
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
    if lowp is not None and (lowp.dtype not in _LOWP_TAKES
                             or not lowp.is_contiguous()
                             or lowp.numel() != n
                             or lowp.device != p.device):
        raise ValueError(f"lowp must be a contiguous {_LOWP_TAKES} buffer "
                         f"of {n} elements on {p.device}")
    lib = _build.library("fused_adam")
    with torch.cuda.device(p.device):
        rc = lib.apex_adam_pipeline(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if lowp is None else lowp.data_ptr(), n,
            *(float(x) for x in hyp), int(bool(adam_w_mode)),
            _build.dtype_code(g.dtype),
            _build.dtype_code(lowp.dtype) if lowp is not None else 0,
            _build.stream_ptr(p.device))
    _build.check("fused_adam", rc, "fused_adam_pipeline kernel")
    bump("fused_adam_pipeline")


def adam_pipeline(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                  v: torch.Tensor, lowp: Optional[torch.Tensor] = None, *,
                  grad_scale: float, lr: float, beta1: float, beta2: float,
                  eps: float, weight_decay: float, bias_correction1: float,
                  bias_correction2: float, adam_w_mode: bool = True,
                  keep: bool = True):
    """The Adam update sweep over one flat group, in place: scale the
    grads by ``grad_scale`` (unscale times clip), Adam or AdamW, the
    skip-select ``keep`` (False leaves p, m, v bitwise unchanged), and
    the master->model cast into ``lowp``.  Returns ``(p, m, v, lowp)``."""
    hyp = (lr, beta1, beta2, eps, weight_decay, bias_correction1,
           bias_correction2, grad_scale, 1.0 if keep else 0.0)
    if p.device.type == "cpu":
        return adam_pipeline_reference(
            g, p, m, v, lowp, grad_scale=grad_scale, lr=lr, beta1=beta1,
            beta2=beta2, eps=eps, weight_decay=weight_decay,
            bias_correction1=bias_correction1,
            bias_correction2=bias_correction2, adam_w_mode=adam_w_mode,
            keep=keep)
    if p.device.type != "cuda":
        raise ValueError(f"adam_pipeline runs on cuda or cpu, not "
                         f"{p.device}")
    _launch(g, p, m, v, lowp, hyp, adam_w_mode)
    return p, m, v, lowp
