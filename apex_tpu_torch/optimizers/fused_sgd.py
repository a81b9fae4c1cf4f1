"""FusedSGD: momentum SGD in its staged per-leaf form and its persistent
pipeline form.

Port of ``apex_tpu/optimizers/fused_sgd.py:29-200`` — ``fused_sgd`` with
``fused_step`` (the single-pass step the staged amp route takes, one
:func:`~apex_tpu_torch.ops.sgd_step` kernel a leaf) and ``pipeline_init``
/ ``pipeline_step`` (one :func:`~apex_tpu_torch.ops.sgd_pipeline` sweep
a flat group).  The semantics are JAX's, which are the reference's
FusedSGD (momentum, dampening, Nesterov, weight decay before or after the
momentum): the first step sets the momentum buffer to the gradient
(``first = count == 0``, and only with a momentum); with ``momentum ==
0`` there is no buffer and the step is ``p - lr * (g + wd * p)`` in
plain torch, as JAX writes it outside any kernel.  The staged step
always advances the count (amp skips around it); the pipeline step
advances it only on a finite step, holding masters and momentum bitwise
otherwise.  The count lives on the host.  ``max_grad_norm`` and
learning-rate schedules are not ported and raise; the optax-style
``update`` (row 19's ``sgd_update``) is not ported.

``kernels=False`` runs the plain versions on any device (the oracle
configuration); otherwise CUDA buffers go through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops.fused_optim import f32, sgd_step, sgd_step_reference
from ..ops.fused_pipeline import sgd_pipeline, sgd_pipeline_reference

__all__ = ["FusedSGD", "FusedSGDState", "fused_sgd"]


@dataclasses.dataclass
class FusedSGDState:
    """Step count (host int) and the fp32 momentum buffers: one a leaf
    (staged) or one a flat group (pipeline)."""

    count: int
    momentum: Tuple[torch.Tensor, ...]


def _plain_no_momentum(g, p, lowp, lr, weight_decay, gscale=1.0,
                       keep=True):
    """``momentum == 0``: ``p - lr * (g * gscale + wd * p)`` in fp32, as
    JAX's jnp expression (no kernel, no buffer), kept on a skip."""
    lr_, wd, gs = (torch.full((), x, dtype=torch.float32, device=p.device)
                   for x in (f32(lr), f32(weight_decay), f32(gscale)))
    if keep:
        p.copy_(p - lr_ * (g.float() * gs + wd * p))
    if lowp is not None:
        lowp.copy_(p)


@dataclasses.dataclass(frozen=True)
class FusedSGD:
    """The FusedSGD hyperparameters and its two entry points."""

    learning_rate: float
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False
    wd_after_momentum: bool = False
    kernels: bool = True

    def _hyp(self, count: int) -> dict:
        return dict(lr=self.learning_rate, momentum=self.momentum,
                    dampening=self.dampening,
                    weight_decay=self.weight_decay, nesterov=self.nesterov,
                    wd_after_momentum=self.wd_after_momentum,
                    first_run=bool(self.momentum) and count == 0)

    def init(self, masters: Sequence[torch.Tensor]) -> FusedSGDState:
        """Zero momentum, one buffer a master (the staged route)."""
        return FusedSGDState(count=0, momentum=tuple(
            torch.zeros_like(p) for p in masters))

    def fused_step(self, grads: Sequence[torch.Tensor], state: FusedSGDState,
                   masters: Sequence[torch.Tensor],
                   lowps: Sequence[Optional[torch.Tensor]]
                   ) -> FusedSGDState:
        """One step a leaf, in place: each fp32 master and its momentum
        updated, the model copy written into its ``lowps`` entry (None
        where the master is the parameter itself).  Gradients arrive
        unscaled, in their own dtype.  Returns the new state."""
        hyp = self._hyp(state.count)
        step = sgd_step if self.kernels else sgd_step_reference
        for g, p, mom, lowp in zip(grads, masters, state.momentum, lowps):
            if self.momentum == 0.0:
                _plain_no_momentum(g, p, lowp, self.learning_rate,
                                   self.weight_decay)
            else:
                step(g, p, mom, lowp, **hyp)
        return dataclasses.replace(state, count=state.count + 1)

    def pipeline_init(self, masters: Sequence[torch.Tensor],
                      segments=None) -> FusedSGDState:
        """Zero momentum in the layout of the flat fp32 master buffers
        (``segments`` is not needed: SGD is elementwise)."""
        return self.init(masters)

    def pipeline_step(self, gbufs: Sequence[torch.Tensor],
                      state: FusedSGDState,
                      master_bufs: Sequence[torch.Tensor],
                      lowp_bufs: Sequence, *, grad_scale: float = 1.0,
                      grad_norm=None, finite: bool = True) -> FusedSGDState:
        """One SGD sweep a flat group, in place, the gradients scaled by
        ``grad_scale`` (amp's inverse loss scale) inside it.  ``finite``
        False keeps masters and momentum bitwise (the model copy is
        re-cast from the unchanged master) and holds the count;
        ``grad_norm`` is accepted and unused (no clipping).  Returns the
        new state."""
        finite = bool(finite)
        hyp = self._hyp(state.count)
        sweep = sgd_pipeline if self.kernels else sgd_pipeline_reference
        for g, p, mom, lowp in zip(gbufs, master_bufs, state.momentum,
                                   lowp_bufs):
            if self.momentum == 0.0:
                _plain_no_momentum(g, p, lowp, self.learning_rate,
                                   self.weight_decay, grad_scale, finite)
            else:
                sweep(g, p, mom, lowp, grad_scale=grad_scale, keep=finite,
                      **hyp)
        return dataclasses.replace(state,
                                   count=state.count + (1 if finite else 0))


def fused_sgd(learning_rate: float, momentum: float = 0.0,
              dampening: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False, wd_after_momentum: bool = False,
              max_grad_norm=None, *, kernels: bool = True) -> FusedSGD:
    """Build FusedSGD (ref: ``apex_tpu/optimizers/fused_sgd.py:29``)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError(
            "Nesterov momentum requires a momentum and zero dampening "
            "(ref: apex/optimizers/fused_sgd.py:61-62)")
    if max_grad_norm is not None:
        raise NotImplementedError(
            "max_grad_norm (global-norm clipping) is not ported yet")
    if callable(learning_rate):
        raise NotImplementedError(
            "learning-rate schedules are not ported yet; pass a number")
    return FusedSGD(float(learning_rate), float(momentum), float(dampening),
                    float(weight_decay), bool(nesterov),
                    bool(wd_after_momentum), kernels)
