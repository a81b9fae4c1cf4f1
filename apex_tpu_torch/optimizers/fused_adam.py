"""FusedAdam in its persistent-pipeline form.

Port of ``apex_tpu/optimizers/fused_adam.py:110-272`` — ``fused_adam``
with ``pipeline_init`` and ``pipeline_step`` — for the amp pipeline of
:mod:`apex_tpu_torch.amp.mixed_precision`: the moments live in one flat
fp32 buffer per group, and one sweep per group (the
:func:`~apex_tpu_torch.ops.adam_pipeline` kernel) updates masters and
moments in place and writes the model-dtype copy.  Bias corrections are
taken at ``count + 1`` in fp32, and the count holds still on a skipped
step, as in the JAX ``pipeline_step`` (:231-269).  The count lives on
the host; the step's finite flag is the one amp measured and read back
(a static scale passes True unchecked).  ``max_grad_norm`` (global norm
clipping) and learning-rate schedules are not ported yet;
``max_grad_norm`` raises.

``kernels=False`` runs the sweep's plain version on any device (the
oracle configuration); otherwise CUDA buffers go through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.fused_pipeline import adam_pipeline, adam_pipeline_reference

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam"]

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
        c = np.float32(count)
        one = np.float32(1.0)
        return (float(one - np.float32(self.beta1) ** c),
                float(one - np.float32(self.beta2) ** c))

    def pipeline_init(self, masters: Sequence[torch.Tensor]
                      ) -> FusedAdamState:
        """Zero moments in the layout of the flat fp32 master buffers."""
        return FusedAdamState(
            count=0, m=tuple(torch.zeros_like(p) for p in masters),
            v=tuple(torch.zeros_like(p) for p in masters))

    def pipeline_step(self, gbufs: Sequence[torch.Tensor],
                      state: FusedAdamState,
                      master_bufs: Sequence[torch.Tensor],
                      lowp_bufs: Sequence, *, grad_scale: float = 1.0,
                      finite: bool = True) -> FusedAdamState:
        """One Adam sweep per group over the flat buffers, in place:
        masters and moments updated, the model copy written into
        ``lowp_bufs`` (None for an fp32 group).  ``grad_scale`` is amp's
        inverse loss scale; ``finite`` False skips the step (state
        bitwise unchanged, count held).  Returns the new state."""
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
    return FusedAdam(learning_rate, beta1, beta2, eps, weight_decay,
                     adam_w_mode, bias_correction, kernels)
