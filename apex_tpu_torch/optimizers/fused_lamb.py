"""FusedLAMB in its staged per-leaf form and its persistent-pipeline form.

Port of ``apex_tpu/optimizers/fused_lamb.py:41-300`` — ``fused_lamb``
with ``fused_step`` (:120, over ``_deltas`` :73-110 and
``_global_grad_clip`` :205) and ``pipeline_init`` / ``pipeline_step`` —
for the two routes of :mod:`apex_tpu_torch.amp.mixed_precision`.  A step
over the groups (the pipeline's flat groups, or the staged route's one
master a leaf):

1. the global gradient norm: on the pipeline the unscaled norm amp's
   checked sweep measured (``grad_norm``), or, under a static scale
   where amp ran no sweep, the norm/finite sweep over the flat gradients
   (row 20 of the kernel table; JAX's ``packed_norm``), its norm only;
   on the staged route the fp32 norm of the (unscaled) gradients;
2. the clip factor ``min(1, max_grad_norm / norm)`` (JAX's
   ``_grad_clip_factor``) and amp's unscale folded into one device fp32
   ``gscale``: the step reads nothing back to the host;
3. phase 1 per group, the kernel (:func:`~apex_tpu_torch.ops.
   lamb_phase1`): the moments in place and the update direction ``u``;
4. phase 2 in plain torch, as it is jnp in JAX (``_trust_ratio_elem``):
   per tensor, ``ratio = |p| / |u|`` where both are nonzero, else 1 —
   applied only with ``use_nvlamb`` or a nonzero weight decay, as the
   reference's ``use_nvlamb || decay != 0`` gate; the norms and the
   scaling run over the tensors (views of the flat ``u`` and master
   buffers on the pipeline) with ``torch._foreach_norm`` and
   ``torch._foreach_mul_``;
5. ``p -= lr * ratio * u`` and the model-dtype copy.

The count rule is JAX's (``:167-176``): the learning rate (a number, or
a schedule: a callable of the host count) and the bias corrections are
taken at ``count + 1``, and ``count`` advances only on a finite step.
On the pipeline the finite flag is the host bool amp read (True
unchecked); a non-finite step leaves masters and moments bitwise as they
were and re-casts the model copy from the masters.  The staged step
always advances the count: amp skips around it.  A parameter whose
gradient is all zero (a table the forward never read) is still stepped:
``u = wd * p`` gives ratio ``1 / wd``, so it moves by ``lr * p``, as in
JAX.

``kernels=False`` runs phase 1 and the norm sweep through their plain
versions on any device (the oracle configuration).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..ops.fused_optim import _scalar, lamb_phase1, lamb_phase1_reference
from ..ops.fused_pipeline import grad_norm_finite, grad_norm_finite_reference
from .fused_adam import (ScalarOrSchedule, _clip_enabled, _global_norm,
                         _grad_clip_factor, _lr_at, bias_corrections)

__all__ = ["FusedLAMB", "FusedLAMBState", "fused_lamb"]


@dataclasses.dataclass
class FusedLAMBState:
    """Step count (host int), the fp32 moments one per group (a flat
    group on the pipeline, a master on the staged route), and each
    group's tensor sizes in order (``sizes``), the per-tensor views phase
    2 reduces over."""

    count: int
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    sizes: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class FusedLAMB:
    """The FusedLAMB hyperparameters and its staged and pipeline entry
    points."""

    learning_rate: ScalarOrSchedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    bias_correction: bool = True
    grad_averaging: bool = True
    adam_w_mode: bool = True
    max_grad_norm: Optional[float] = 1.0
    use_nvlamb: bool = False
    kernels: bool = True

    def bias_corrections(self, count: int) -> Tuple[float, float]:
        """``(1 - beta1**count, 1 - beta2**count)`` in fp32."""
        if not self.bias_correction:
            return 1.0, 1.0
        return bias_corrections(self.beta1, self.beta2, count)

    def staged_init(self, masters: Sequence[torch.Tensor]) -> FusedLAMBState:
        """Zero moments, one pair a master in its shape: the state
        ``fused_step`` walks (each master its own tensor, as JAX's direct
        groups)."""
        return FusedLAMBState(
            count=0, m=tuple(torch.zeros_like(p) for p in masters),
            v=tuple(torch.zeros_like(p) for p in masters),
            sizes=tuple((p.numel(),) for p in masters))

    def pipeline_init(self, masters: Sequence[torch.Tensor],
                      segments: Sequence[Sequence[int]]) -> FusedLAMBState:
        """Zero moments in the layout of the flat fp32 master buffers;
        ``segments`` gives each group's tensor sizes in order (the trust
        ratio is per tensor, so there is no default)."""
        sizes = tuple(tuple(int(n) for n in seg) for seg in segments)
        for p, seg in zip(masters, sizes):
            if sum(seg) != p.numel():
                raise ValueError(f"segments {seg} do not tile a buffer of "
                                 f"{p.numel()} elements")
        return FusedLAMBState(
            count=0, m=tuple(torch.zeros_like(p) for p in masters),
            v=tuple(torch.zeros_like(p) for p in masters), sizes=sizes)

    def _gscale(self, gbufs, grad_scale: float, grad_norm, device
                ) -> torch.Tensor:
        """amp's unscale times the clip factor, a device fp32 scalar."""
        scale = _scalar(grad_scale, device)
        if not _clip_enabled(self.max_grad_norm):
            return scale
        if grad_norm is None:
            sweep = grad_norm_finite if self.kernels else \
                grad_norm_finite_reference
            grad_norm = sweep(gbufs, grad_scale)[0]
        return scale * _grad_clip_factor(_scalar(grad_norm, device),
                                         self.max_grad_norm)

    def _adapt(self, us: List[torch.Tensor], ps: List[torch.Tensor]
               ) -> None:
        """Phase 2: scale each tensor of ``us`` by its trust ratio
        against its master in ``ps``, in place; nothing where the gate
        leaves every tensor un-adapted (ratio 1)."""
        if not (self.use_nvlamb or self.weight_decay != 0.0):
            return
        pn = torch.stack(torch._foreach_norm(ps))
        un = torch.stack(torch._foreach_norm(us))
        ratio = torch.where((pn > 0) & (un > 0),
                            pn / torch.clamp(un, min=1e-12),
                            torch.ones((), device=pn.device))
        torch._foreach_mul_(us, list(ratio.unbind()))

    def _phase1(self, g, p, m, v, gscale, count: int) -> torch.Tensor:
        """Phase 1 over one group at step ``count``: ``u``, the moments
        in place."""
        bc1, bc2 = self.bias_corrections(count)
        phase1 = lamb_phase1 if self.kernels else lamb_phase1_reference
        u, _, _ = phase1(g, p, m, v, grad_scale=gscale, beta1=self.beta1,
                         beta2=self.beta2,
                         beta3=1.0 - self.beta1 if self.grad_averaging
                         else 1.0, eps=self.eps,
                         weight_decay=self.weight_decay,
                         bias_correction1=bc1, bias_correction2=bc2,
                         adam_w_mode=self.adam_w_mode)
        return u

    def fused_step(self, grads: Sequence[torch.Tensor],
                   state: FusedLAMBState, masters: Sequence[torch.Tensor],
                   lowps: Sequence) -> FusedLAMBState:
        """One LAMB step over every leaf, in place (JAX's ``fused_step``
        on its direct groups): the global norm of the unscaled
        ``grads`` and its clip factor on the device, phase 1 a leaf with
        the factor as its scale, the trust ratio a leaf, each fp32 master
        stepped and its model copy written into its ``lowps`` entry (None
        where the master is the parameter itself).  Returns the new
        state, the count advanced."""
        stepped = state.count + 1
        gscale = 1.0
        if _clip_enabled(self.max_grad_norm):
            gscale = _grad_clip_factor(_global_norm(grads),
                                       self.max_grad_norm)
        us = [self._phase1(g, p, m, v, gscale, stepped) for g, p, m, v in
              zip(grads, masters, state.m, state.v)]
        self._apply(us, list(masters), list(lowps),
                    _lr_at(self.learning_rate, stepped))
        return dataclasses.replace(state, count=stepped)

    def _apply(self, us, ps, lowps, lr: float) -> None:
        """Phase 2, then ``p -= lr * u`` and the model copies, over
        lists of tensors."""
        self._adapt(us, ps)
        torch._foreach_mul_(us, lr)
        torch._foreach_sub_(ps, us)
        pairs = [(lp, p) for lp, p in zip(lowps, ps) if lp is not None]
        if pairs:
            torch._foreach_copy_([lp for lp, _ in pairs],
                                 [p for _, p in pairs])

    def pipeline_step(self, gbufs: Sequence[torch.Tensor],
                      state: FusedLAMBState,
                      master_bufs: Sequence[torch.Tensor],
                      lowp_bufs: Sequence, *, grad_scale: float = 1.0,
                      grad_norm: Union[None, float, torch.Tensor] = None,
                      finite: bool = True) -> FusedLAMBState:
        """One LAMB step over the flat buffers, in place: masters and
        moments updated, the model copy written into ``lowp_bufs`` (None
        for an fp32 group).  ``grad_scale`` is amp's inverse loss scale,
        ``grad_norm`` the unscaled global norm if amp measured it (a
        float or a device scalar), ``finite`` False skips the step (state
        bitwise unchanged, count held).  Returns the new state."""
        if not finite:
            for p, lowp in zip(master_bufs, lowp_bufs):
                if lowp is not None:
                    lowp.copy_(p)
            return state
        stepped = state.count + 1
        dev = master_bufs[0].device
        gscale = self._gscale(gbufs, grad_scale, grad_norm, dev)
        lr = _lr_at(self.learning_rate, stepped)
        for g, p, m, v, lowp, sizes in zip(gbufs, master_bufs, state.m,
                                           state.v, lowp_bufs, state.sizes):
            u = self._phase1(g, p, m, v, gscale, stepped)
            self._adapt(list(u.split(sizes)), list(p.split(sizes)))
            p.sub_(u.mul_(lr))
            if lowp is not None:
                lowp.copy_(p)
        return dataclasses.replace(state, count=stepped)


def fused_lamb(learning_rate: ScalarOrSchedule = 1e-3, beta1: float = 0.9,
               beta2: float = 0.999, eps: float = 1e-6,
               weight_decay: float = 0.01, bias_correction: bool = True,
               grad_averaging: bool = True, adam_w_mode: bool = True,
               max_grad_norm: Optional[float] = 1.0,
               use_nvlamb: bool = False, *, kernels: bool = True
               ) -> FusedLAMB:
    """Build FusedLAMB (ref: ``apex_tpu/optimizers/fused_lamb.py:41``);
    ``eps`` must be positive, as in JAX (``:56``)."""
    if eps <= 0.0:
        raise ValueError("fused_lamb requires eps > 0")
    return FusedLAMB(learning_rate, beta1, beta2, eps, weight_decay,
                     bias_correction, grad_averaging, adam_w_mode,
                     max_grad_norm, use_nvlamb, kernels)
