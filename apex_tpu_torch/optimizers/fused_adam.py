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
:func:`~apex_tpu_torch.ops.adam_step_leaves` call over every leaf (a
kernel launch a dtype pair and table of leaves) updates the masters and
moments in place and writes the model-dtype copies; the count always
advances (amp skips around the step).  Pipeline: the moments live in
one flat fp32 buffer per group, and one sweep per group (the
:func:`~apex_tpu_torch.ops.adam_pipeline` kernel) does the same with
amp's unscale and skip folded in; the count holds still on a skipped
step, as in the JAX ``pipeline_step`` (:231-269).  Bias corrections are
taken at ``count + 1`` in fp32 on both routes.  The count lives on the
host; the step's finite flag is the one amp measured and read back (a
static scale passes True unchecked).

``max_grad_norm`` (JAX's ``_clip_enabled``: None or a number <= 0 is
off) clips by the global norm, on all three routes as JAX does
(``:141-150``, ``:177-186``, ``:231-252``): ``update`` and ``fused_step``
scale the gradients, in fp32, by ``_grad_clip_factor`` of their norm
before the step (``_staged_clip``); ``pipeline_step`` folds the factor
into the sweep's scale, from amp's measured norm or, under a static
scale, from the norm sweep (JAX's ``packed_norm``).  The Adam sweep
takes its scale as a host float, so a clipped pipeline step reads the
norm to the host once.  ``learning_rate`` may be a schedule: a Python
callable from the host step count to a float, read at ``count + 1`` on
every route (on the pipeline even on a skipped step, as JAX's).

``kernels=False`` runs the plain versions on any device (the oracle
configuration); otherwise CUDA buffers go through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import multi_tensor
from ..ops.fused_optim import (adam_step_leaves, adam_step_leaves_reference,
                               adam_update, adam_update_reference)
from ..ops.fused_pipeline import (adam_pipeline, adam_pipeline_reference,
                                  grad_norm_finite,
                                  grad_norm_finite_reference)

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]

ScalarOrSchedule = Union[float, Callable[[int], float]]


def _lr_at(lr: ScalarOrSchedule, count: int) -> float:
    """The learning rate at host step ``count``: a schedule called on it,
    or the number itself (JAX's ``_lr_at``)."""
    return float(lr(count)) if callable(lr) else lr


def _clip_enabled(max_norm) -> bool:
    """Clipping on?  None or a number <= 0 turns it off."""
    return not (max_norm is None or max_norm <= 0)


def _grad_clip_factor(gnorm, max_norm):
    """``min(1, max_norm / norm)`` in JAX's guarded form, ``where(norm >
    max_norm, max_norm / max(norm, 1e-12), 1)`` in fp32: a 0-d tensor on
    the norm's device for a tensor norm (nothing read back), a float for
    a host norm; 1.0 with clipping off."""
    if not _clip_enabled(max_norm):
        return 1.0
    if isinstance(gnorm, torch.Tensor):
        gn = gnorm.to(torch.float32)
        mx = torch.full((), max_norm, dtype=torch.float32, device=gn.device)
        return torch.where(gn > mx, mx / torch.clamp(gn, min=1e-12),
                           torch.ones((), device=gn.device))
    gn, mx = np.float32(gnorm), np.float32(max_norm)
    return float(mx / max(gn, np.float32(1e-12))) if gn > mx else 1.0


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 global L2 norm of ``grads`` as a 0-d tensor on their
    device: each buffer's norm read in fp32 from its own dtype, then the
    norm of those."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))


def _staged_clip(gbufs: Sequence[torch.Tensor], max_norm):
    """The staged routes' clip: with clipping on, every buffer in fp32
    times the factor of their global norm (a device scalar: no host
    read); else the buffers as they are."""
    if not _clip_enabled(max_norm):
        return list(gbufs)
    clip = _grad_clip_factor(_global_norm(gbufs), max_norm)
    return [g.float() * clip for g in gbufs]


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

    learning_rate: ScalarOrSchedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    max_grad_norm: Optional[float] = None
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
        lr = _lr_at(self.learning_rate, count)
        bc1, bc2 = self.bias_corrections(count)
        metas = multi_tensor.compute_metas(params, split_direct=True)
        gbufs = _staged_clip(multi_tensor.group_buffers(grads, metas),
                             self.max_grad_norm)
        pbufs = multi_tensor.group_buffers(params, metas)
        fn = adam_update if self.kernels else adam_update_reference
        deltas, new_m, new_v = [], [], []
        for gb, pb, m, v in zip(gbufs, pbufs, state.m, state.v):
            d, m2, v2 = fn(gb, pb, m, v, lr=lr,
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
        """One Adam step over every leaf, in place: each fp32 master and
        its moments updated, the model copy written into its ``lowps``
        entry (None where the master is the parameter itself).  Gradients
        arrive unscaled, in their own dtype (in fp32 once clipped).
        Returns the new state."""
        count = state.count + 1
        bc1, bc2 = self.bias_corrections(count)
        step = adam_step_leaves if self.kernels \
            else adam_step_leaves_reference
        step(_staged_clip(grads, self.max_grad_norm), masters, state.m,
             state.v, lowps, lr=_lr_at(self.learning_rate, count),
             beta1=self.beta1, beta2=self.beta2, eps=self.eps,
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
        inverse loss scale; ``grad_norm`` amp's measured unscaled norm (a
        float or a device scalar), which the clip reads, measured here
        by the norm sweep when amp ran none; ``finite`` False skips the
        step (state bitwise unchanged, count held).  Returns the new
        state."""
        bc1, bc2 = self.bias_corrections(state.count + 1)
        gscale = grad_scale
        if _clip_enabled(self.max_grad_norm):
            if grad_norm is None:
                norm_sweep = grad_norm_finite if self.kernels \
                    else grad_norm_finite_reference
                grad_norm = norm_sweep(gbufs, grad_scale)[0]
            # the sweep takes its scale as a host float: the step's one
            # read of the norm
            clip = _grad_clip_factor(float(grad_norm), self.max_grad_norm)
            gscale = float(np.float32(grad_scale) * np.float32(clip))
        sweep = adam_pipeline if self.kernels else adam_pipeline_reference
        for g, p, m, v, lowp in zip(gbufs, master_bufs, state.m, state.v,
                                    lowp_bufs):
            sweep(g, p, m, v, lowp, grad_scale=gscale,
                  lr=_lr_at(self.learning_rate, state.count + 1),
                  beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                  weight_decay=self.weight_decay, bias_correction1=bc1,
                  bias_correction2=bc2, adam_w_mode=self.adam_w_mode,
                  keep=finite)
        return dataclasses.replace(state,
                                   count=state.count + (1 if finite else 0))


def fused_adam(learning_rate: ScalarOrSchedule = 1e-3, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-8,
               weight_decay: float = 0.0, adam_w_mode: bool = True,
               bias_correction: bool = True, max_grad_norm=None, *,
               kernels: bool = True) -> FusedAdam:
    """Build FusedAdam (ref: ``apex_tpu/optimizers/fused_adam.py:110``);
    ``learning_rate`` a number or a schedule (a callable of the step
    count), ``max_grad_norm`` None (off) or the global-norm bound."""
    return FusedAdam(learning_rate, beta1, beta2, eps, weight_decay,
                     adam_w_mode, bias_correction, max_grad_norm, kernels)
