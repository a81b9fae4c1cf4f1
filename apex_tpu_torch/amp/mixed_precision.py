"""Mixed-precision training: the policy cast, fp32 masters, the loss
scale, and the three optimizer routes the JAX package takes.

Port of ``apex_tpu/amp/mixed_precision.py`` (``AmpOptimizer``,
``initialize``) for every policy.  ``initialize(model, optimizer,
opt_level, pipeline=None)``:

1. snapshots fp32 masters from the module's parameters *before* the
   cast, so no precision is lost at initialization (policies with master
   weights, O2 and O5);
2. casts the module per the policy (:func:`~.cast.cast_params`: every
   parameter but batch-norm ones to the model dtype; O3 casts every
   parameter to fp16; O0, O1 and O4 leave the module fp32);
3. routes the step as JAX's ``AmpOptimizer._route_pipeline`` (:170-192)
   does: ``pipeline=True`` always takes the persistent pipeline,
   ``pipeline=False`` the staged route, and the default packs only when
   the policy has master weights and the cast model's bytes
   (:func:`packed_nbytes`, JAX's ``packed_nbytes`` rule) reach
   :data:`PIPELINE_PACK_MIN_BYTES` (the default of JAX's
   ``APEX_TPU_PIPELINE_PACK_MIN_BYTES``, ``1 << 27``).  GPT-345M (710 MB
   in bf16) packs at O5; ResNet-50 (51 MB) takes the staged route.
   ``pipeline=True`` for a policy without master weights raises
   ``ValueError``, as JAX's constructor does (:102-111).

**The persistent pipeline** (``_apply_gradients_pipeline``, :144-151,
:313-383): the parameters of each dtype group become views of one flat
buffer, and their ``.grad`` of another (:func:`~apex_tpu_torch.ops.
flatten_params`), with the masters and the optimizer's state in flat
fp32 buffers beside them; a step is one fused sweep per group
(``optimizer.pipeline_step``), which unscales, steps the masters and
state, and writes the model copy into the parameters in place.

**The staged route** (``apply_gradients``, :202-311): ``.grad`` are
ordinary tensors, and a step unscales the gradients in their own dtype
(:func:`~.scaler.unscale`), then runs ``optimizer.fused_step`` on the
state of ``optimizer.staged_init`` (fp32 moments, one buffer a stepped
tensor) — one call over every parameter, a kernel launch a dtype lane
and table of parameters.  With master weights the masters are kept one
a parameter (an fp32 parameter, such as a batch norm's under O5, is its
own master) and the step writes each model copy straight into its
parameter's storage where the kernel emits it (JAX's ``_lowp_dtype_for``:
the model dtype differs from the master's).  Without them (O0, O1, O3,
O4; JAX's :155-160, :249-301) the stepped tensors are the parameters
themselves, in their own dtype (O3's fp16: fp32 arithmetic, fp32
moments, the parameter rounded back once; the optimizer must declare
``steps_model_dtype``), and no copy is written.

On every route, whether the step inspects the gradients follows
``check_finite`` (:meth:`AmpOptimizer._resolve_check`): by default only
under a dynamic scale (O1, O2), as the JAX package and apex's static
``LossScaler``.  A checked step reads one flag on the host.  The
pipeline measures it with the norm/finite sweep (row 20), which also
gives the unscaled global norm (``pipeline_step(grad_norm=...)``:
FusedLAMB's clip reads it); the staged route with
:func:`~.scaler.all_finite` over the unscaled gradients, and reports no
norm, as JAX's.  A non-finite step keeps masters (or parameters),
optimizer state and model bitwise, holds the optimizer's count and backs
the scale off.  Under a static scale (O0, O3, O4, O5) nothing is checked
and nothing is read back.

A policy that casts ops (O1, O4) needs its forward under
:func:`~.autocast.autocast`: :meth:`AmpOptimizer.scale_loss` raises
``RuntimeError`` for a loss that no autocast region in the policy's
compute dtype returned, rather than step a model that ran in fp32
unnoticed.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import cast as _cast
from . import scaler as _scaler
from .autocast import autocast_dtype_of
from ..ops.fused_pipeline import (FlatGroup, flatten_params,
                                  grad_norm_finite,
                                  grad_norm_finite_reference)
from .policy import Policy, get_policy

__all__ = ["StepInfo", "AmpOptimizer", "initialize", "packed_nbytes",
           "PIPELINE_PACK_MIN_BYTES"]

# the cast model's bytes from which the default route packs: the
# default of apex_tpu/analysis/flags.py:192
PIPELINE_PACK_MIN_BYTES = 1 << 27


def packed_nbytes(named_params: Iterable[Tuple[str, torch.Tensor]],
                  policy: Policy) -> int:
    """The bytes of the parameters in the dtypes ``policy``'s cast gives
    them (JAX's ``packed_nbytes`` of the cast template), from shapes and
    names alone: parameters on the ``meta`` device will do."""
    return sum(p.numel() * _cast.cast_dtype(name, p, policy).itemsize
               for name, p in named_params)


class StepInfo(NamedTuple):
    """What a step reports (the JAX ``StepInfo``).  Unchecked (a static
    scale by default), ``grads_checked`` is False, ``grads_finite`` True
    means "unchecked" and ``grad_norm`` is None; checked, ``grads_finite``
    is the measured flag and, on the pipeline, ``grad_norm`` the norm
    sweep's unscaled global norm (the staged route measures none)."""

    grads_finite: bool
    loss_scale: float
    steps_skipped: int
    grads_checked: bool = False
    grad_norm: Optional[float] = None


class AmpOptimizer:
    """Pairs a fused optimizer (``fused_adam``, ``fused_sgd``,
    ``fused_lamb``) with a precision policy over one module's
    parameters, on the route :meth:`route_pipeline` picks."""

    def __init__(self, optimizer, policy: Policy,
                 check_finite: Optional[bool] = None,
                 pipeline: Optional[bool] = None):
        self.use_masters = bool(policy.master_weights)
        if pipeline and not self.use_masters:
            raise ValueError(f"pipeline=True requires master weights "
                             f"(policy.master_weights); policy "
                             f"{policy.opt_level} has none")
        if pipeline and getattr(optimizer, "pipeline_step", None) is None:
            raise ValueError(f"pipeline=True requires an optimizer with a "
                             f"pipeline form (pipeline_init/pipeline_step); "
                             f"{type(optimizer).__name__} has none")
        self.optimizer = optimizer
        self.policy = policy
        self.scaler = _scaler.init(policy.loss_scale)
        # None: inspect the gradients only under a dynamic scale; True
        # forces the check (and the skip) under a static one too
        self.check_finite = check_finite
        self._resolve_check()
        self.pipeline = pipeline
        # decided by init(): the persistent pipeline or the staged route
        self.use_pipeline: Optional[bool] = None
        self.groups: List[FlatGroup] = []
        self.params: List[Tuple[str, nn.Parameter]] = []
        self._masters: List[torch.Tensor] = []
        self.state = None

    def route_pipeline(self, named_params) -> bool:
        """JAX's init-time routing (``_route_pipeline``): an explicit
        ``pipeline`` wins; by default the persistent pipeline only when
        the cast model holds at least :data:`PIPELINE_PACK_MIN_BYTES`
        bytes.  ``named_params`` may lie on the ``meta`` device.  A
        policy without master weights always takes the staged route."""
        if not self.use_masters:
            return False
        if self.pipeline is not None:
            return bool(self.pipeline)
        if getattr(self.optimizer, "pipeline_step", None) is None:
            return False
        return packed_nbytes(named_params,
                             self.policy) >= PIPELINE_PACK_MIN_BYTES

    def init(self, module: nn.Module, masters: dict) -> "AmpOptimizer":
        """Route, then set up the route over ``module``'s (already cast)
        trainable parameters and build the optimizer state; ``masters``
        are the fp32 values by name from before the cast (empty for a
        policy without master weights: the parameters are stepped
        themselves)."""
        named = [(n, p) for n, p in module.named_parameters()
                 if p.requires_grad]
        self.use_pipeline = self.route_pipeline(named)
        if self.use_pipeline:
            self.groups = flatten_params(named, masters)
            self.state = self.optimizer.pipeline_init(
                [g.master for g in self.groups],
                segments=[tuple(p.numel() for p in g.params)
                          for g in self.groups])
            return self
        self.params = named
        if not self.use_masters:
            low = sorted({str(p.dtype) for _, p in named
                          if p.dtype != torch.float32})
            if low and not getattr(self.optimizer, "steps_model_dtype",
                                   False):
                raise NotImplementedError(
                    f"{type(self.optimizer).__name__} steps fp32 "
                    f"parameters only; policy {self.policy.opt_level} "
                    f"keeps {low} parameters with no master copy")
            self._masters = [p.data for _, p in named]
            self.state = self.optimizer.staged_init(self._masters)
            return self
        # an fp32 parameter is its own master (stepped in place)
        self._masters = [p.data if p.dtype == torch.float32
                         else masters[n].contiguous() for n, p in named]
        self.state = self.optimizer.staged_init(self._masters)
        return self

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss to call ``backward()`` on: ``loss.float() * scale``.
        Under a policy that casts ops (O1, O4) the loss must be one that
        :func:`~.autocast.autocast` returned in the policy's compute
        dtype: raises ``RuntimeError`` otherwise."""
        if self.policy.cast_ops and \
                autocast_dtype_of(loss) != self.policy.cast_ops_type:
            raise RuntimeError(
                f"policy {self.policy.opt_level} casts ops: compute the "
                f"loss under amp.autocast(policy=...); this loss was not "
                f"returned by an autocast region in "
                f"{self.policy.cast_ops_type}")
        return _scaler.scale_loss(loss, self.scaler)

    def zero_grad(self) -> None:
        """Pipeline: zero the flat gradient buffers (the ``.grad`` views
        stay).  Staged: drop the gradients, so backward writes fresh
        ones."""
        for g in self.groups:
            g.grad.zero_()
        for _, p in self.params:
            p.grad = None

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
        then unscale, step the masters and state (or keep them on an
        overflow), write the model copy into the parameters, and advance
        the scaler — on the route :meth:`init` chose."""
        if self.use_pipeline:
            return self._apply_gradients_pipeline()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in self.params]
        grads = _scaler.unscale(grads, self.scaler)
        check = self._resolve_check()
        finite = True                      # unchecked
        if check:
            # the step's one host read
            finite = bool(_scaler.all_finite(grads))
        if finite:
            # no copy where the stepped tensor is the parameter itself
            lowps = [None if not self.use_masters
                     or p.dtype == torch.float32 else p.data
                     for _, p in self.params]
            self.state = self.optimizer.fused_step(
                grads, self.state, self._masters, lowps)
        self.scaler = _scaler.update(self.scaler, finite)
        return StepInfo(grads_finite=finite,
                        loss_scale=self.scaler.loss_scale,
                        steps_skipped=self.scaler.steps_skipped,
                        grads_checked=check)

    def _apply_gradients_pipeline(self) -> StepInfo:
        """The persistent pipeline's step: one sweep per dtype group."""
        self._check_views()
        inv = 1.0 / self.scaler.loss_scale
        gbufs = [g.grad for g in self.groups]
        check = self._resolve_check()
        gnorm = norm_t = None
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
            [g.lowp for g in self.groups], grad_scale=inv,
            grad_norm=norm_t, finite=finite)
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
        """The fp32 masters by parameter name, as views; empty for a
        policy without master weights."""
        if not self.use_masters:
            return {}
        if not self.use_pipeline:
            return {n: m for (n, _), m in zip(self.params, self._masters)}
        return {name: g.master_of(i) for g in self.groups
                for i, name in enumerate(g.names)}


def initialize(model: nn.Module, optimizer, opt_level: str = "O5",
               check_finite: Optional[bool] = None,
               pipeline: Optional[bool] = None
               ) -> Tuple[nn.Module, AmpOptimizer]:
    """``model, amp_opt = amp.initialize(model, optimizer,
    opt_level=..., pipeline=None)``: masters snapshotted from the fp32
    weights (policies with master weights), the module cast in place per
    the policy, the route chosen
    (``pipeline``: see the module docstring) and built."""
    policy = get_policy(opt_level)
    amp_opt = AmpOptimizer(optimizer, policy, check_finite, pipeline)
    masters = _cast.master_copy(model) if amp_opt.use_masters else {}
    _cast.cast_params(model, policy)
    return model, amp_opt.init(model, masters)
