"""FusedAdam in its optax-style ``update`` form, its staged per-leaf form
and its persistent-pipeline form.

Port of ``apex_tpu/optimizers/fused_adam.py:110-272`` — ``fused_adam``
with ``init`` and ``update`` (:131-175), ``fused_step`` (:177-215),
``pipeline_init`` and ``pipeline_step``.  ``update(grads, state, params)``
returns the deltas (in each parameter's dtype) for
:func:`~apex_tpu_torch.optimizers.apply_updates` and the new state; its
state is laid out by :func:`~apex_tpu_torch.ops.multi_tensor.compute_metas`
with ``split_direct`` (one fp32 moment pair a leaf while
``multi_tensor.DIRECT_MIN_ELEMS`` is 0, JAX's default; flat padded
buffers for packed groups once it is raised), and one
:func:`~apex_tpu_torch.ops.adam_update` runs a group.  The other two are
for the two routes of :mod:`apex_tpu_torch.amp.mixed_precision`.
Staged: the moments live in one fp32 buffer a leaf, and one
:func:`~apex_tpu_torch.ops.adam_step` kernel a leaf updates the master
and moments in place and writes the model-dtype copy; the count always
advances (amp skips around the step).  Pipeline: the moments live in
one flat fp32 buffer per group, and one sweep per group (the
:func:`~apex_tpu_torch.ops.adam_pipeline` kernel) does the same with
amp's unscale and skip folded in; the count holds still on a skipped
step, as in the JAX ``pipeline_step`` (:231-269).  Bias corrections are
taken at ``count + 1`` in fp32 on both routes.  The count lives on the
host; the step's finite flag is the one amp measured and read back (a
static scale passes True unchecked).  ``max_grad_norm`` (global norm
clipping) and learning-rate schedules are not ported yet and raise.

``kernels=False`` runs the plain versions on any device (the oracle
configuration); otherwise CUDA buffers go through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import multi_tensor
from ..ops.fused_optim import (adam_step, adam_step_reference, adam_update,
                               adam_update_reference)
from ..ops.fused_pipeline import adam_pipeline, adam_pipeline_reference

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]


def bias_corrections(beta1: float, beta2: float,
                     count: int) -> Tuple[float, float]:
    """``(1 - beta1**count, 1 - beta2**count)`` in fp32, as JAX forms
    them from the step count."""
    c = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** c),
            float(one - np.float32(beta2) ** c))


@dataclasses.dataclass
class FusedAdamState:
    """Step count (host int) and the flat fp32 moments, one per group."""

    count: int
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class FusedAdam:
    """The FusedAdam hyperparameters and its pipeline entry points."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    kernels: bool = True

    def bias_corrections(self, count: int) -> Tuple[float, float]:
        """``(1 - beta1**count, 1 - beta2**count)`` in fp32."""
        if not self.bias_correction:
            return 1.0, 1.0
        return bias_corrections(self.beta1, self.beta2, count)

    def init(self, params: Sequence[torch.Tensor]) -> FusedAdamState:
        """Zero fp32 moments over ``compute_metas(params,
        split_direct=True)``: one pair a leaf, in its shape, while
        ``multi_tensor.DIRECT_MIN_ELEMS`` is 0."""
        metas = multi_tensor.compute_metas(params, split_direct=True)
        dev = params[0].device if params else None
        m = multi_tensor.state_zeros(metas, dev)
        return FusedAdamState(count=0, m=m,
                              v=tuple(torch.zeros_like(z) for z in m))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: FusedAdamState,
               params: Optional[Sequence[torch.Tensor]] = None):
        """The optax-style step: ``(updates, new_state)``, the deltas in
        each parameter's dtype (nothing updated in place).  One
        ``adam_update`` a group of ``compute_metas(params,
        split_direct=True)``; bias corrections at ``count + 1``."""
        if params is None:
            raise ValueError("fused_adam requires params in update()")
        count = state.count + 1
        bc1, bc2 = self.bias_corrections(count)
        metas = multi_tensor.compute_metas(params, split_direct=True)
        gbufs = multi_tensor.group_buffers(grads, metas)
        pbufs = multi_tensor.group_buffers(params, metas)
        fn = adam_update if self.kernels else adam_update_reference
        deltas, new_m, new_v = [], [], []
        for gb, pb, m, v in zip(gbufs, pbufs, state.m, state.v):
            d, m2, v2 = fn(gb, pb, m, v, lr=self.learning_rate,
                           beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                           weight_decay=self.weight_decay,
                           bias_correction1=bc1, bias_correction2=bc2,
                           adam_w_mode=self.adam_w_mode)
            deltas.append(d)
            new_m.append(m2)
            new_v.append(v2)
        updates = multi_tensor.assemble(deltas, metas,
                                        [p.dtype for p in params])
        return updates, FusedAdamState(count, tuple(new_m), tuple(new_v))

    def fused_step(self, grads: Sequence[torch.Tensor],
                   state: FusedAdamState, masters: Sequence[torch.Tensor],
                   lowps: Sequence) -> FusedAdamState:
        """One Adam step a leaf, in place: each fp32 master and its
        moments updated, the model copy written into its ``lowps`` entry
        (None where the master is the parameter itself).  Gradients
        arrive unscaled, in their own dtype.  Returns the new state."""
        bc1, bc2 = self.bias_corrections(state.count + 1)
        step = adam_step if self.kernels else adam_step_reference
        for g, p, m, v, lowp in zip(grads, masters, state.m, state.v,
                                    lowps):
            step(g, p, m, v, lowp, lr=self.learning_rate, beta1=self.beta1,
                 beta2=self.beta2, eps=self.eps,
                 weight_decay=self.weight_decay, bias_correction1=bc1,
                 bias_correction2=bc2, adam_w_mode=self.adam_w_mode)
        return dataclasses.replace(state, count=state.count + 1)

    def staged_init(self, masters: Sequence[torch.Tensor]
                    ) -> FusedAdamState:
        """Zero moments, one pair a master in its shape: the state
        ``fused_step`` walks, whatever ``multi_tensor.DIRECT_MIN_ELEMS``
        is."""
        return FusedAdamState(
            count=0, m=tuple(torch.zeros_like(p) for p in masters),
            v=tuple(torch.zeros_like(p) for p in masters))

    def pipeline_init(self, masters: Sequence[torch.Tensor],
                      segments=None) -> FusedAdamState:
        """Zero moments in the layout of the flat fp32 master buffers
        (``segments``, the groups' tensor sizes, is not needed: Adam is
        elementwise)."""
        return self.staged_init(masters)

    def pipeline_step(self, gbufs: Sequence[torch.Tensor],
                      state: FusedAdamState,
                      master_bufs: Sequence[torch.Tensor],
                      lowp_bufs: Sequence, *, grad_scale: float = 1.0,
                      grad_norm=None, finite: bool = True) -> FusedAdamState:
        """One Adam sweep per group over the flat buffers, in place:
        masters and moments updated, the model copy written into
        ``lowp_bufs`` (None for an fp32 group).  ``grad_scale`` is amp's
        inverse loss scale; ``grad_norm`` (amp's measured norm) is
        accepted and unused, since ``max_grad_norm`` is not ported;
        ``finite`` False skips the step (state bitwise unchanged, count
        held).  Returns the new state."""
        bc1, bc2 = self.bias_corrections(state.count + 1)
        sweep = adam_pipeline if self.kernels else adam_pipeline_reference
        for g, p, m, v, lowp in zip(gbufs, master_bufs, state.m, state.v,
                                    lowp_bufs):
            sweep(g, p, m, v, lowp, grad_scale=grad_scale,
                  lr=self.learning_rate,
                  beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                  weight_decay=self.weight_decay, bias_correction1=bc1,
                  bias_correction2=bc2, adam_w_mode=self.adam_w_mode,
                  keep=finite)
        return dataclasses.replace(state,
                                   count=state.count + (1 if finite else 0))


def fused_adam(learning_rate: float = 1e-3, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True, max_grad_norm=None, *,
               kernels: bool = True) -> FusedAdam:
    """Build FusedAdam (ref: ``apex_tpu/optimizers/fused_adam.py:110``)."""
    if max_grad_norm is not None:
        raise NotImplementedError(
            "max_grad_norm (global-norm clipping) is not ported yet")
    if callable(learning_rate):
        raise NotImplementedError(
            "learning-rate schedules are not ported yet; pass a number")
    return FusedAdam(learning_rate, beta1, beta2, eps, weight_decay,
                     adam_w_mode, bias_correction, kernels)
