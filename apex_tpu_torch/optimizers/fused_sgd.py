"""FusedSGD: momentum SGD in its optax-style ``update`` form, its staged
per-leaf form and its persistent pipeline form.

Port of ``apex_tpu/optimizers/fused_sgd.py:29-200`` — ``fused_sgd`` with
``init`` / ``update`` (:44-88: the deltas for
:func:`~apex_tpu_torch.optimizers.apply_updates`, one
:func:`~apex_tpu_torch.ops.sgd_update` a group of
``compute_metas(params, split_direct=True)``), ``fused_step`` (the
single-pass step the staged amp route takes: one
:func:`~apex_tpu_torch.ops.sgd_step_leaves` call over every leaf, a
kernel launch a dtype pair and table of leaves) and
``pipeline_init`` / ``pipeline_step`` (one
:func:`~apex_tpu_torch.ops.sgd_pipeline` sweep a flat group). The
semantics are JAX's, which are the reference's FusedSGD (momentum,
dampening, Nesterov, weight decay before or after the momentum): the
first step sets the momentum buffer to the gradient (``first = count ==
0``, and only with a momentum); with ``momentum == 0`` there is no
buffer and the step is ``p - lr * (g + wd * p)`` (the delta ``-lr * (g +
wd * p)``) in plain torch, as JAX writes it outside any kernel.
``update`` and the staged step always advance the count (amp skips
around the step); the pipeline step advances it only on a finite step,
holding masters and momentum bitwise otherwise. The count lives on the
host. ``max_grad_norm`` clips by the global norm and ``learning_rate``
may be a schedule (a callable of the host count), as
:mod:`~apex_tpu_torch.optimizers.fused_adam` takes them (JAX's
``:54``, ``:95``, ``:161``): the learning rate at ``count + 1``; the
staged routes scale the gradients in fp32 before the step; the pipeline
folds the clip factor, a device scalar, into the sweep's scale, which
the SGD sweep reads from device memory (no host read).

``kernels=False`` runs the plain versions on any device (the oracle
configuration); otherwise CUDA buffers go through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops import multi_tensor
from ..ops.fused_optim import (_scalar, f32, sgd_step_leaves,
                               sgd_step_leaves_reference, sgd_update,
                               sgd_update_reference)
from ..ops.fused_pipeline import (grad_norm_finite,
                                  grad_norm_finite_reference, sgd_pipeline,
                                  sgd_pipeline_reference)
from .fused_adam import (ScalarOrSchedule, _clip_enabled,
                         _grad_clip_factor, _lr_at, _staged_clip)

__all__ = ["FusedSGD", "FusedSGDState", "fused_sgd"]


@dataclasses.dataclass
class FusedSGDState:
    """Step count (host int) and the fp32 momentum buffers: one a leaf
    (staged) or one a flat group (pipeline)."""

    count: int
    momentum: Tuple[torch.Tensor, ...]


def _no_momentum_delta(g, p, lr, weight_decay, gscale=1.0):
    """``momentum == 0``: the fp32 delta ``-lr * (g * gscale + wd * p)``,
    as JAX's jnp expression (no kernel, no buffer); ``gscale`` a number
    or a 0-d device tensor."""
    nlr, wd = (torch.full((), x, dtype=torch.float32, device=p.device)
               for x in (-f32(lr), f32(weight_decay)))
    gs = _scalar(gscale, p.device)
    return nlr * (g.float() * gs + wd * p.float())


def _plain_no_momentum(g, p, lowp, lr, weight_decay, gscale=1.0,
                       keep=True):
    """``momentum == 0`` in place: ``p += delta`` (kept on a skip), the
    model copy cast from ``p``."""
    if keep:
        p.add_(_no_momentum_delta(g, p, lr, weight_decay, gscale))
    if lowp is not None:
        lowp.copy_(p)


@dataclasses.dataclass(frozen=True)
class FusedSGD:
    """The FusedSGD hyperparameters and its two entry points."""

    learning_rate: ScalarOrSchedule
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False
    wd_after_momentum: bool = False
    max_grad_norm: Optional[float] = None
    kernels: bool = True

    def _hyp(self, count: int) -> dict:
        """The step's hyperparameters from the state's ``count``: the
        learning rate at ``count + 1``, the first-run flag at 0."""
        return dict(lr=_lr_at(self.learning_rate, count + 1),
                    momentum=self.momentum,
                    dampening=self.dampening,
                    weight_decay=self.weight_decay, nesterov=self.nesterov,
                    wd_after_momentum=self.wd_after_momentum,
                    first_run=bool(self.momentum) and count == 0)

    def init(self, params: Sequence[torch.Tensor]) -> FusedSGDState:
        """Zero fp32 momentum over ``compute_metas(params,
        split_direct=True)``: one buffer a leaf, in its shape, while
        ``multi_tensor.DIRECT_MIN_ELEMS`` is 0."""
        metas = multi_tensor.compute_metas(params, split_direct=True)
        dev = params[0].device if params else None
        return FusedSGDState(count=0,
                             momentum=multi_tensor.state_zeros(metas, dev))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: FusedSGDState,
               params: Optional[Sequence[torch.Tensor]] = None):
        """The optax-style step: ``(updates, new_state)``, the deltas in
        each parameter's dtype (nothing updated in place)."""
        if params is None:
            raise ValueError("fused_sgd requires params in update()")
        hyp = self._hyp(state.count)
        metas = multi_tensor.compute_metas(params, split_direct=True)
        gbufs = _staged_clip(multi_tensor.group_buffers(grads, metas),
                             self.max_grad_norm)
        pbufs = multi_tensor.group_buffers(params, metas)
        fn = sgd_update if self.kernels else sgd_update_reference
        deltas, new_mom = [], []
        for gb, pb, mom, meta in zip(gbufs, pbufs, state.momentum, metas):
            if self.momentum == 0.0:
                d = _no_momentum_delta(gb, pb, hyp["lr"],
                                       self.weight_decay).to(meta.dtype)
                mom2 = mom
            else:
                d, mom2 = fn(gb, pb, mom, **hyp)
            deltas.append(d)
            new_mom.append(mom2)
        updates = multi_tensor.assemble(deltas, metas,
                                        [p.dtype for p in params])
        return updates, FusedSGDState(state.count + 1, tuple(new_mom))

    def fused_step(self, grads: Sequence[torch.Tensor], state: FusedSGDState,
                   masters: Sequence[torch.Tensor],
                   lowps: Sequence[Optional[torch.Tensor]]
                   ) -> FusedSGDState:
        """One step over every leaf, in place: each fp32 master and its
        momentum updated, the model copy written into its ``lowps`` entry
        (None where the master is the parameter itself).  Gradients arrive
        unscaled, in their own dtype (in fp32 once clipped).  Returns the
        new state."""
        hyp = self._hyp(state.count)
        grads = _staged_clip(grads, self.max_grad_norm)
        if self.momentum == 0.0:
            for g, p, lowp in zip(grads, masters, lowps):
                _plain_no_momentum(g, p, lowp, hyp["lr"], self.weight_decay)
        else:
            step = sgd_step_leaves if self.kernels \
                else sgd_step_leaves_reference
            step(grads, masters, state.momentum, lowps, **hyp)
        return dataclasses.replace(state, count=state.count + 1)

    def staged_init(self, masters: Sequence[torch.Tensor]
                    ) -> FusedSGDState:
        """Zero momentum, one buffer a master in its shape: the state
        ``fused_step`` walks, whatever ``multi_tensor.DIRECT_MIN_ELEMS``
        is."""
        return FusedSGDState(count=0, momentum=tuple(
            torch.zeros_like(p) for p in masters))

    def pipeline_init(self, masters: Sequence[torch.Tensor],
                      segments=None) -> FusedSGDState:
        """Zero momentum in the layout of the flat fp32 master buffers
        (``segments`` is not needed: SGD is elementwise)."""
        return self.staged_init(masters)

    def pipeline_step(self, gbufs: Sequence[torch.Tensor],
                      state: FusedSGDState,
                      master_bufs: Sequence[torch.Tensor],
                      lowp_bufs: Sequence, *, grad_scale: float = 1.0,
                      grad_norm=None, finite: bool = True) -> FusedSGDState:
        """One SGD sweep a flat group, in place, the gradients scaled by
        ``grad_scale`` (amp's inverse loss scale) inside it.  ``finite``
        False keeps masters and momentum bitwise (the model copy is
        re-cast from the unchanged master) and holds the count.
        ``grad_norm`` is amp's measured unscaled norm, which the clip
        reads (measured here by the norm sweep when amp ran none); the
        clip factor joins ``grad_scale`` on the device.  Returns the new
        state."""
        finite = bool(finite)
        hyp = self._hyp(state.count)
        gscale = grad_scale
        if _clip_enabled(self.max_grad_norm) and gbufs:
            dev = master_bufs[0].device
            if grad_norm is None:
                norm_sweep = grad_norm_finite if self.kernels \
                    else grad_norm_finite_reference
                grad_norm = norm_sweep(gbufs, grad_scale)[0]
            gscale = _scalar(grad_scale, dev) * _grad_clip_factor(
                _scalar(grad_norm, dev), self.max_grad_norm)
        sweep = sgd_pipeline if self.kernels else sgd_pipeline_reference
        for g, p, mom, lowp in zip(gbufs, master_bufs, state.momentum,
                                   lowp_bufs):
            if self.momentum == 0.0:
                _plain_no_momentum(g, p, lowp, hyp["lr"], self.weight_decay,
                                   gscale, finite)
            else:
                sweep(g, p, mom, lowp, grad_scale=gscale, keep=finite,
                      **hyp)
        return dataclasses.replace(state,
                                   count=state.count + (1 if finite else 0))


def fused_sgd(learning_rate: ScalarOrSchedule, momentum: float = 0.0,
              dampening: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False, wd_after_momentum: bool = False,
              max_grad_norm=None, *, kernels: bool = True) -> FusedSGD:
    """Build FusedSGD (ref: ``apex_tpu/optimizers/fused_sgd.py:29``)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires a momentum and zero dampening "
            "(ref: apex/optimizers/fused_sgd.py:61-62)")
    lr = learning_rate if callable(learning_rate) else float(learning_rate)
    return FusedSGD(lr, float(momentum), float(dampening),
                    float(weight_decay), bool(nesterov),
                    bool(wd_after_momentum), max_grad_norm, kernels)
