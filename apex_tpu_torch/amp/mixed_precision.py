"""Mixed-precision training: the policy cast, fp32 masters, the loss
scale and the persistent fused optimizer pipeline.

Port of ``apex_tpu/amp/mixed_precision.py`` (``AmpOptimizer``,
``initialize``) on its persistent-pipeline path
(``_apply_gradients_pipeline``, :144-151, :313-383), the path GPT-345M
takes under O5 and O2.  ``initialize(model, optimizer, opt_level)``:

1. snapshots fp32 masters from the module's parameters *before* the
   cast, so no precision is lost at initialization;
2. casts the module per the policy (:func:`~.cast.cast_params`: every
   parameter but batch-norm ones to the model dtype);
3. flattens the parameters of each dtype group into one buffer, and
   their ``.grad`` into another (:func:`~apex_tpu_torch.ops.
   flatten_params`), with the masters and the optimizer's moments in
   flat fp32 buffers beside them.

Each step: :meth:`AmpOptimizer.zero_grad`, backward of
:meth:`AmpOptimizer.scale_loss`, then :meth:`AmpOptimizer.
apply_gradients` — one fused sweep per group, which unscales, steps the
masters and moments, and writes the model copy into the parameters in
place.  Whether the step inspects the gradients follows
``check_finite`` (:meth:`AmpOptimizer._resolve_check`): by default only
under a dynamic scale (O2), as the JAX package and apex's static
``LossScaler``.  A checked step first runs the norm/finite sweep (row 20
of the kernel table) for the unscaled global norm and the finite flag,
reads the flag on the host once, and hands it to the Adam sweep: a
non-finite step keeps masters and moments bitwise, re-casts the model
copy from them, holds the optimizer's count and backs the scale off.
Under a static scale (O5) the sweep is not run and nothing is read
back.  A policy without master weights raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import cast as _cast
from . import scaler as _scaler
from ..ops.fused_pipeline import (FlatGroup, flatten_params,
                                  grad_norm_finite,
                                  grad_norm_finite_reference)
from .policy import Policy, get_policy

__all__ = ["StepInfo", "AmpOptimizer", "initialize"]


class StepInfo(NamedTuple):
    """What a step reports (the JAX ``StepInfo``).  Unchecked (a static
    scale by default), ``grads_checked`` is False, ``grads_finite`` True
    means "unchecked" and ``grad_norm`` is None; checked, they are the
    norm sweep's measured flag and unscaled global norm."""

    grads_finite: bool
    loss_scale: float
    steps_skipped: int
    grads_checked: bool = False
    grad_norm: Optional[float] = None


class AmpOptimizer:
    """Pairs a pipeline-capable optimizer (``fused_adam``) with a
    precision policy over one module's flat parameter groups."""

    def __init__(self, optimizer, policy: Policy,
                 check_finite: Optional[bool] = None):
        if not policy.master_weights:
            raise NotImplementedError(
                f"the port's amp takes the persistent fused pipeline, which "
                f"needs master weights; policy {policy.opt_level} has none")
        if getattr(optimizer, "pipeline_step", None) is None:
            raise ValueError(f"{type(optimizer).__name__} has no pipeline "
                             f"form (pipeline_init/pipeline_step)")
        self.optimizer = optimizer
        self.policy = policy
        self.scaler = _scaler.init(policy.loss_scale)
        # None: inspect the gradients only under a dynamic scale; True
        # forces the check (and the skip) under a static one too
        self.check_finite = check_finite
        self._resolve_check()
        self.groups: List[FlatGroup] = []
        self.state = None

    def init(self, module: nn.Module, masters: dict) -> "AmpOptimizer":
        """Flatten ``module``'s (already cast) trainable parameters and
        build the optimizer state; ``masters`` are the fp32 values by
        name from before the cast."""
        named = [(n, p) for n, p in module.named_parameters()
                 if p.requires_grad]
        self.groups = flatten_params(named, masters)
        self.state = self.optimizer.pipeline_init(
            [g.master for g in self.groups])
        return self

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss to call ``backward()`` on: ``loss.float() * scale``."""
        return _scaler.scale_loss(loss, self.scaler)

    def zero_grad(self) -> None:
        """Zero the flat gradient buffers (the ``.grad`` views stay)."""
        for g in self.groups:
            g.grad.zero_()

    def _resolve_check(self) -> bool:
        """Inspect the gradients this step?  None (the default): only
        under a dynamic scale; False is refused for a dynamic scale,
        whose schedule needs the flag (ref:
        ``apex_tpu/amp/mixed_precision.py:313-325``)."""
        if self.check_finite is None:
            return self.scaler.dynamic
        if not self.check_finite and self.scaler.dynamic:
            raise ValueError("check_finite=False is invalid with a dynamic "
                             "loss scaler: the scale schedule needs the "
                             "finite flag")
        return bool(self.check_finite)

    def apply_gradients(self) -> StepInfo:
        """Check the gradients where :meth:`_resolve_check` says so,
        then unscale, step the masters and moments (or keep them on an
        overflow), write the model copy into the parameters — one sweep
        per dtype group — and advance the scaler."""
        self._check_views()
        inv = 1.0 / self.scaler.loss_scale
        gbufs = [g.grad for g in self.groups]
        check = self._resolve_check()
        gnorm = None
        finite = True                      # unchecked
        if check:
            # the optimizer's kernels=False (the oracle configuration)
            # takes the plain norm sweep too
            plain = not getattr(self.optimizer, "kernels", True)
            sweep = grad_norm_finite_reference if plain else grad_norm_finite
            norm_t, finite_t = sweep(gbufs, inv)
            # the step's one host read: the flag (and the norm with it)
            norm_v, finite_v = torch.stack(
                [norm_t.float(), finite_t.float()]).tolist()
            gnorm, finite = norm_v, finite_v > 0.5
        self.state = self.optimizer.pipeline_step(
            gbufs, self.state, [g.master for g in self.groups],
            [g.lowp for g in self.groups], grad_scale=inv, finite=finite)
        self.scaler = _scaler.update(self.scaler, finite)
        return StepInfo(grads_finite=finite,
                        loss_scale=self.scaler.loss_scale,
                        steps_skipped=self.scaler.steps_skipped,
                        grads_checked=check, grad_norm=gnorm)

    def _check_views(self) -> None:
        """Raise if a parameter or its ``.grad`` is no longer its view of
        the flat buffers (``module.zero_grad()`` sets grads to None, a
        ``.to()`` replaces ``.data``): the sweep would then read stale
        gradients or write where the module no longer reads."""
        for g in self.groups:
            esize = g.data.element_size()
            base, gbase = g.data.data_ptr(), g.grad.data_ptr()
            for name, p, off in zip(g.names, g.params, g.offsets):
                if p.data_ptr() != base + off * esize or p.grad is None \
                        or p.grad.data_ptr() != gbase + off * esize:
                    raise RuntimeError(
                        f"{name} or its .grad is no longer a view of the "
                        f"flat buffers amp.initialize made; zero gradients "
                        f"with amp_opt.zero_grad(), not module.zero_grad()")

    def masters(self) -> dict:
        """The fp32 masters by parameter name, as views."""
        return {name: g.master_of(i) for g in self.groups
                for i, name in enumerate(g.names)}


def initialize(model: nn.Module, optimizer, opt_level: str = "O5",
               check_finite: Optional[bool] = None
               ) -> Tuple[nn.Module, AmpOptimizer]:
    """``model, amp_opt = amp.initialize(model, optimizer,
    opt_level=...)``: masters snapshotted from the fp32 weights, the
    module cast in place per the policy, the flat pipeline built."""
    policy = get_policy(opt_level)
    amp_opt = AmpOptimizer(optimizer, policy, check_finite)
    masters = _cast.master_copy(model)
    _cast.cast_params(model, policy)
    return model, amp_opt.init(model, masters)
