"""FusedMixedPrecisionLamb: LAMB stepping reduced-precision parameters
from fp32 masters it owns, aware of the loss scaler.

Port of ``apex_tpu/optimizers/fused_mixed_precision_lamb.py:38-187``
(``init``, ``step``, ``state_dict``, ``load_state_dict``), the LAMB Apex
added for BERT pretraining.  The parameters are bf16 or fp16 (fp32
leaves may sit among them); the optimizer keeps an fp32 master, ``m``
and ``v`` for every parameter, one tensor each in the parameter's shape
(JAX packs them per dtype group; the trust ratio is per tensor either
way).  JAX's ``reduced_precision_dtype``, which its step never reads,
has no counterpart: each parameter's own dtype is its copy's.
``step(grads, state, params, scaler_state)``, JAX's rules:

* the gradients are the loss-scaled ones; the step's finite flag is
  read from them on the host once (the port's scaler lives on the
  host);
* an overflow holds masters, ``m``, ``v``, the parameters and the count
  bitwise, and the scaler backs off;
* on a finite step the count advances first and the learning rate (a
  number or a schedule, a callable of the host count) and the bias
  corrections are read at the new count (``:121-122``);
* the global norm is of the scaled gradients, so the clip threshold is
  ``max_grad_norm * scale`` (``:133-136``), and the clip factor and the
  unscale join in one device scale for phase 1
  (:func:`~apex_tpu_torch.ops.lamb_phase1`, row 19 of the kernel table,
  a launch a parameter);
* phase 2 and the master step are :class:`~apex_tpu_torch.optimizers.
  fused_lamb.FusedLAMB`'s, and every parameter is re-emitted as the
  cast of its master, in place;
* the reported ``grad_norm`` is the unscaled one, a device scalar.

``kernels=False`` runs phase 1 through its plain version (the oracle
configuration).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..amp import scaler as _scaler
from ..ops.fused_optim import _scalar
from .fused_adam import (ScalarOrSchedule, _clip_enabled, _global_norm,
                         _grad_clip_factor, _lr_at)
from .fused_lamb import FusedLAMB

__all__ = ["FusedMixedPrecisionLamb", "MixedPrecisionLambState",
           "MPLambInfo"]


@dataclasses.dataclass
class MixedPrecisionLambState:
    """Step count (host int, finite steps only), and an fp32 master,
    ``m`` and ``v`` a parameter, each in the parameter's shape."""

    count: int
    masters: Tuple[torch.Tensor, ...]
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


class MPLambInfo(NamedTuple):
    """What a step reports: the host finite flag and the unscaled global
    norm (a 0-d device tensor; None on a skipped step)."""

    grads_finite: bool
    grad_norm: Optional[torch.Tensor]


class FusedMixedPrecisionLamb:
    """``opt = FusedMixedPrecisionLamb(lr); state = opt.init(params);
    params, state, scaler, info = opt.step(grads, state, params,
    scaler)``, the parameters stepped in place."""

    def __init__(self, learning_rate: ScalarOrSchedule = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 bias_correction: bool = True, grad_averaging: bool = True,
                 adam_w_mode: bool = True,
                 max_grad_norm: Optional[float] = 1.0,
                 use_nvlamb: bool = False, *, kernels: bool = True):
        if eps <= 0.0:
            raise ValueError("FusedMixedPrecisionLamb requires eps > 0")
        self.learning_rate = learning_rate
        self.max_grad_norm = max_grad_norm
        # phase 1 and 2 and the master step are FusedLAMB's, unclipped:
        # the clip here is on the scaled norm
        self._lamb = FusedLAMB(learning_rate, beta1, beta2, eps,
                               weight_decay, bias_correction,
                               grad_averaging, adam_w_mode, None,
                               use_nvlamb, kernels)

    def init(self, params: Sequence[torch.Tensor]
             ) -> MixedPrecisionLambState:
        """fp32 masters copied from ``params`` (an fp32 parameter's too)
        and zero moments."""
        masters = tuple(p.detach().float().clone() for p in params)
        return MixedPrecisionLambState(
            count=0, masters=masters,
            m=tuple(torch.zeros_like(b) for b in masters),
            v=tuple(torch.zeros_like(b) for b in masters))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             state: MixedPrecisionLambState, params: Sequence[torch.Tensor],
             scaler_state: Optional[_scaler.ScalerState] = None):
        """One conditional LAMB step: ``(params, new_state,
        new_scaler_state, info)``, ``params`` written in place from the
        new masters (held on an overflow)."""
        finite = bool(_scaler.all_finite(list(grads)))
        new_scaler = _scaler.update(scaler_state, finite) \
            if scaler_state is not None else None
        if not finite:
            return params, state, new_scaler, MPLambInfo(False, None)
        count = state.count + 1
        dev = state.masters[0].device
        scale = scaler_state.loss_scale if scaler_state is not None else 1.0
        inv = _scalar(1.0 / scale, dev)
        gnorm = _global_norm(grads)
        gscale = inv
        if _clip_enabled(self.max_grad_norm):
            gscale = inv * _grad_clip_factor(gnorm,
                                             self.max_grad_norm * scale)
        lamb = self._lamb
        us = [lamb._phase1(g, p, m, v, gscale, count) for g, p, m, v in
              zip(grads, state.masters, state.m, state.v)]
        lamb._apply(us, list(state.masters), list(params),
                    _lr_at(self.learning_rate, count))
        return params, dataclasses.replace(state, count=count), \
            new_scaler, MPLambInfo(True, gnorm * inv)

    def state_dict(self, state: MixedPrecisionLambState) -> dict:
        """The count and the fp32 masters and moments (the masters kept
        in full precision, ``:73-117``)."""
        return {"count": int(state.count),
                "masters": [b.clone() for b in state.masters],
                "m": [b.clone() for b in state.m],
                "v": [b.clone() for b in state.v]}

    def load_state_dict(self, d: dict, device=None
                        ) -> MixedPrecisionLambState:
        """Inverse of :meth:`state_dict`: every buffer fp32, on
        ``device`` (None: where each lies)."""
        def buf(x):
            return torch.as_tensor(x).to(device=device,
                                         dtype=torch.float32).clone()

        return MixedPrecisionLambState(
            count=int(d["count"]),
            masters=tuple(buf(b) for b in d["masters"]),
            m=tuple(buf(b) for b in d["m"]),
            v=tuple(buf(b) for b in d["v"]))
