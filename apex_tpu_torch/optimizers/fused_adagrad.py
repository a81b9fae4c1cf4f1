"""FusedAdagrad in its optax-style ``update`` form.

Port of ``apex_tpu/optimizers/fused_adagrad.py`` (``fused_adagrad``,
:20-54): the state is the step count (on the host) and one fp32 sum of
squared gradients a group of ``compute_metas(params, split_direct=True)``
(a leaf's shape while ``multi_tensor.DIRECT_MIN_ELEMS`` is 0);
``update(grads, state, params)`` runs one
:func:`~apex_tpu_torch.ops.adagrad_update` a group (L2 decay into the
gradient, ``delta = -lr * g / (sqrt(h) + eps)``) and returns the deltas in
each parameter's dtype for :func:`~apex_tpu_torch.optimizers.apply_updates`
with the new state.  ``learning_rate`` may be a schedule, a callable of
the host step count, read at ``count + 1`` (JAX's ``:33``).

``kernels=False`` runs the plain version on any device (the oracle
configuration); otherwise CUDA buffers go through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops import multi_tensor
from ..ops.fused_optim import adagrad_update, adagrad_update_reference
from .fused_adam import ScalarOrSchedule, _lr_at

__all__ = ["FusedAdagrad", "FusedAdagradState", "fused_adagrad"]


@dataclasses.dataclass
class FusedAdagradState:
    """Step count (host int) and the fp32 sums of squares, one a group."""

    count: int
    h: Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class FusedAdagrad:
    """The FusedAdagrad hyperparameters and its ``init`` / ``update``."""

    learning_rate: ScalarOrSchedule = 1e-2
    eps: float = 1e-10
    weight_decay: float = 0.0
    kernels: bool = True

    def init(self, params: Sequence[torch.Tensor]) -> FusedAdagradState:
        metas = multi_tensor.compute_metas(params, split_direct=True)
        dev = params[0].device if params else None
        return FusedAdagradState(count=0,
                                 h=multi_tensor.state_zeros(metas, dev))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               state: FusedAdagradState,
               params: Optional[Sequence[torch.Tensor]] = None):
        """``(updates, new_state)``, nothing updated in place."""
        if params is None:
            raise ValueError("fused_adagrad requires params in update()")
        count = state.count + 1
        lr = _lr_at(self.learning_rate, count)
        metas = multi_tensor.compute_metas(params, split_direct=True)
        gbufs = multi_tensor.group_buffers(grads, metas)
        pbufs = multi_tensor.group_buffers(params, metas)
        fn = adagrad_update if self.kernels else adagrad_update_reference
        deltas, new_h = [], []
        for gb, pb, h in zip(gbufs, pbufs, state.h):
            d, h2 = fn(gb, pb, h, lr=lr, eps=self.eps,
                       weight_decay=self.weight_decay)
            deltas.append(d)
            new_h.append(h2)
        updates = multi_tensor.assemble(deltas, metas,
                                        [p.dtype for p in params])
        return updates, FusedAdagradState(count, tuple(new_h))


def fused_adagrad(learning_rate: ScalarOrSchedule = 1e-2,
                  eps: float = 1e-10,
                  weight_decay: float = 0.0, *,
                  kernels: bool = True) -> FusedAdagrad:
    """Build FusedAdagrad (ref:
    ``apex_tpu/optimizers/fused_adagrad.py:20``)."""
    lr = learning_rate if callable(learning_rate) else float(learning_rate)
    return FusedAdagrad(lr, float(eps),
                        float(weight_decay), kernels)
