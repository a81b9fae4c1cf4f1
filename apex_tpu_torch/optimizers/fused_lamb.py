"""FusedLAMB in its persistent-pipeline form.

Port of ``apex_tpu/optimizers/fused_lamb.py:41-300`` — ``fused_lamb``
with ``pipeline_init`` and ``pipeline_step`` — for the amp pipeline of
:mod:`apex_tpu_torch.amp.mixed_precision`.  A step over the flat groups:

1. the global gradient norm: the unscaled norm amp's checked sweep
   measured (``grad_norm``), or, under a static scale where amp ran no
   sweep, the norm/finite sweep over the flat gradients (row 20 of the
   kernel table; JAX's ``packed_norm``), its norm only;
2. the clip factor ``min(1, max_grad_norm / norm)`` (JAX's
   ``_grad_clip_factor``) and amp's unscale folded into one device fp32
   ``gscale``: the step reads nothing back to the host;
3. phase 1 per group, the kernel (:func:`~apex_tpu_torch.ops.
   lamb_phase1`): the moments in place and the update direction ``u``;
4. phase 2 in plain torch, as it is jnp in JAX (``_trust_ratio_elem``):
   per tensor, ``ratio = |p| / |u|`` where both are nonzero, else 1 —
   applied only with ``use_nvlamb`` or a nonzero weight decay, as the
   reference's ``use_nvlamb || decay != 0`` gate; the norms and the
   scaling run over the tensors' views of the flat ``u`` and master
   buffers (``torch._foreach_norm``, ``torch._foreach_mul_``);
5. ``p -= lr * ratio * u`` and the model-dtype copy into the flat
   parameter buffer.

The count rule is JAX's (``:167-176``): the learning rate and the bias
corrections are taken at ``count + 1``, and ``count`` advances only on
a finite step.  The finite flag is the host bool amp read (True
unchecked); a non-finite step leaves masters and moments bitwise as
they were and re-casts the model copy from the masters.  A parameter
whose gradient is all zero (a table the forward never read) is still
stepped: ``u = wd * p`` gives ratio ``1 / wd``, so it moves by
``lr * p``, as in JAX.  Learning-rate schedules are not ported yet.

``kernels=False`` runs phase 1 and the norm sweep through their plain
versions on any device (the oracle configuration).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.fused_optim import lamb_phase1, lamb_phase1_reference
from ..ops.fused_pipeline import grad_norm_finite, grad_norm_finite_reference

__all__ = ["FusedLAMB", "FusedLAMBState", "fused_lamb"]


@dataclasses.dataclass
class FusedLAMBState:
    """Step count (host int), the flat fp32 moments one per group, and
    each group's tensor sizes in order (``sizes``), the per-tensor views
    phase 2 reduces over."""

    count: int
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    sizes: Tuple[Tuple[int, ...], ...]


@dataclasses.dataclass(frozen=True)
class FusedLAMB:
    """The FusedLAMB hyperparameters and its pipeline entry points."""

    learning_rate: float = 1e-3
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
        c = np.float32(count)
        one = np.float32(1.0)
        return (float(one - np.float32(self.beta1) ** c),
                float(one - np.float32(self.beta2) ** c))

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
        scale = torch.full((), grad_scale, dtype=torch.float32,
                           device=device)
        max_norm = self.max_grad_norm
        if max_norm is None or max_norm <= 0:
            return scale
        if grad_norm is None:
            sweep = grad_norm_finite if self.kernels else \
                grad_norm_finite_reference
            grad_norm = sweep(gbufs, grad_scale)[0]
        if not isinstance(grad_norm, torch.Tensor):
            grad_norm = torch.full((), grad_norm, dtype=torch.float32,
                                   device=device)
        gn = grad_norm.to(device=device, dtype=torch.float32)
        clip = torch.where(gn > max_norm,
                           max_norm / torch.clamp(gn, min=1e-12),
                           torch.ones((), device=device))
        return scale * clip

    def _adapt(self, u: torch.Tensor, p: torch.Tensor, sizes) -> None:
        """Phase 2 over one group: scale each tensor's view of ``u`` by
        its trust ratio, in place; nothing where the gate leaves every
        tensor un-adapted (ratio 1)."""
        if not (self.use_nvlamb or self.weight_decay != 0.0):
            return
        views = list(u.split(sizes))
        pn = torch.stack(torch._foreach_norm(list(p.split(sizes))))
        un = torch.stack(torch._foreach_norm(views))
        ratio = torch.where((pn > 0) & (un > 0),
                            pn / torch.clamp(un, min=1e-12),
                            torch.ones((), device=p.device))
        torch._foreach_mul_(views, list(ratio.unbind()))

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
        bc1, bc2 = self.bias_corrections(stepped)
        beta3 = 1.0 - self.beta1 if self.grad_averaging else 1.0
        lr = self.learning_rate
        gscale = self._gscale(gbufs, grad_scale, grad_norm,
                              master_bufs[0].device)
        phase1 = lamb_phase1 if self.kernels else lamb_phase1_reference
        for g, p, m, v, lowp, sizes in zip(gbufs, master_bufs, state.m,
                                           state.v, lowp_bufs, state.sizes):
            u, _, _ = phase1(g, p, m, v, grad_scale=gscale,
                             beta1=self.beta1, beta2=self.beta2,
                             beta3=beta3, eps=self.eps,
                             weight_decay=self.weight_decay,
                             bias_correction1=bc1, bias_correction2=bc2,
                             adam_w_mode=self.adam_w_mode)
            self._adapt(u, p, sizes)
            p.sub_(u.mul_(lr))
            if lowp is not None:
                lowp.copy_(p)
        return dataclasses.replace(state, count=stepped)


def fused_lamb(learning_rate: float = 1e-3, beta1: float = 0.9,
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
