"""FusedNovoGrad in its optax-style ``update`` form.

Port of ``apex_tpu/optimizers/fused_novograd.py:33-133``. NovoGrad keeps
its second moment as one scalar a tensor: the moving average of the
tensor's squared gradient norm (``norm_type`` 2 only), seeded with the
first step's norm unless ``init_zero``. The state is the step count (on
the host), one fp32 first moment a group of ``compute_metas(params,
align=LANE, split_direct=True)`` and one fp32 vector of second moments a
group (one entry a tensor). Each step, per group, in plain torch: the
per-tensor squared norms
(:func:`~apex_tpu_torch.ops.multi_tensor.per_tensor_sumsq` on a packed
group, one sum on a direct one), the new second moments and the
denominators ``sqrt(v / bc2) + eps``. Then a packed group runs
:func:`~apex_tpu_torch.ops.novograd_update` over its per-element
denominator buffer
(:func:`~apex_tpu_torch.ops.multi_tensor.broadcast_per_tensor`, 1.0 in
the gaps); a direct group takes the plain expression with its one scalar
denominator, as JAX's does even when its kernel is forced (a leaf-sized
broadcast would be an extra pass). So the kernel runs only once
``multi_tensor.DIRECT_MIN_ELEMS`` is raised, as in JAX.
``learning_rate`` may be a schedule, a callable of the host step count,
read at ``count + 1`` (JAX's ``:69``).

``kernels=False`` runs the plain versions on any device (the oracle
configuration); otherwise CUDA buffers of packed groups go through the
kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops import multi_tensor
from ..ops.fused_optim import (f32, novograd_update,
                               novograd_update_reference)
from .fused_adam import ScalarOrSchedule, _lr_at, bias_corrections

__all__ = ["FusedNovoGrad", "FusedNovoGradState", "fused_novograd"]


@dataclasses.dataclass
class FusedNovoGradState:
    """Step count (host int), the fp32 first moments one a group and the
    per-tensor fp32 second moments, a (tensors,) vector a group."""

    count: int
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class FusedNovoGrad:
    """The FusedNovoGrad hyperparameters and its ``init`` / ``update``."""

    learning_rate: ScalarOrSchedule = 1e-3
    beta1: float = 0.95
    beta2: float = 0.98
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_averaging: bool = True
    init_zero: bool = False
    bias_correction: bool = True
    kernels: bool = True

    def _metas(self, params):
        return multi_tensor.compute_metas(params, align=multi_tensor.LANE,
                                          split_direct=True)

    def init(self, params: Sequence[torch.Tensor]) -> FusedNovoGradState:
        metas = self._metas(params)
        dev = params[0].device if params else None
        return FusedNovoGradState(
            count=0, m=multi_tensor.state_zeros(metas, dev),
            v=tuple(torch.zeros(len(m.sizes), dtype=torch.float32,
                                device=dev) for m in metas))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               state: FusedNovoGradState,
               params: Optional[Sequence[torch.Tensor]] = None):
        """``(updates, new_state)``, nothing updated in place."""
        if params is None:
            raise ValueError("fused_novograd requires params in update()")
        count = state.count + 1
        bc1, bc2 = (bias_corrections(self.beta1, self.beta2, count)
                    if self.bias_correction else (1.0, 1.0))
        # formed in double and rounded once, as JAX's Python floats are
        beta3 = (1.0 - self.beta1) if self.grad_averaging else 1.0
        metas = self._metas(params)
        gbufs = multi_tensor.group_buffers(grads, metas)
        pbufs = multi_tensor.group_buffers(params, metas)
        kw = dict(lr=_lr_at(self.learning_rate, count), beta1=self.beta1,
                  beta3=beta3,
                  weight_decay=self.weight_decay, bias_correction1=bc1)
        deltas, new_m, new_v = [], [], []
        for gb, pb, m, v, meta in zip(gbufs, pbufs, state.m, state.v,
                                      metas):
            dev = pb.device
            b2, omb2, bc2_, eps = (
                torch.full((), x, dtype=torch.float32, device=dev)
                for x in (f32(self.beta2), f32(1.0 - self.beta2), f32(bc2),
                          f32(self.eps)))
            g32 = gb.float()
            if multi_tensor.is_direct(meta):
                gn_sq = (g32 * g32).sum().reshape(1)
            else:
                gn_sq = multi_tensor.per_tensor_sumsq(g32, meta)
            if state.count == 0 and not self.init_zero:
                v2 = gn_sq          # v0 = ||g1||^2
            else:
                v2 = b2 * v + omb2 * gn_sq
            denom = torch.sqrt(v2 / bc2_) + eps
            if multi_tensor.is_direct(meta):
                d, m2 = novograd_update_reference(gb, pb, m, denom[0], **kw)
            else:
                fn = novograd_update if self.kernels else \
                    novograd_update_reference
                d, m2 = fn(gb, pb, m,
                           multi_tensor.broadcast_per_tensor(denom, meta),
                           **kw)
            deltas.append(d)
            new_m.append(m2)
            new_v.append(v2)
        updates = multi_tensor.assemble(deltas, metas,
                                        [p.dtype for p in params])
        return updates, FusedNovoGradState(count, tuple(new_m),
                                           tuple(new_v))


def fused_novograd(learning_rate: ScalarOrSchedule = 1e-3,
                   beta1: float = 0.95,
                   beta2: float = 0.98, eps: float = 1e-8,
                   weight_decay: float = 0.0, grad_averaging: bool = True,
                   init_zero: bool = False, bias_correction: bool = True,
                   norm_type: int = 2, *,
                   kernels: bool = True) -> FusedNovoGrad:
    """Build FusedNovoGrad (ref:
    ``apex_tpu/optimizers/fused_novograd.py:33``)."""
    if norm_type != 2:
        raise ValueError("only norm_type=2 is supported "
                         "(ref: apex/optimizers/fused_novograd.py)")
    if eps <= 0.0:
        # a tensor whose gradients are all zero has v = 0 and would divide
        # by zero
        raise ValueError("fused_novograd requires eps > 0 "
                         "(zero-grad tensors would divide by zero)")
    lr = learning_rate if callable(learning_rate) else float(learning_rate)
    return FusedNovoGrad(lr, float(beta1), float(beta2),
                         float(eps), float(weight_decay),
                         bool(grad_averaging), bool(init_zero),
                         bool(bias_correction), kernels)
