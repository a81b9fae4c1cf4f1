"""DistributedFusedAdam: ZeRO-sharded Adam over a ``torch.distributed``
group, at one rank.

Port of ``apex_tpu/contrib/optimizers/distributed_fused_adam.py:95-176``
with a process group in place of the mesh axis.  Its ``update(grads,
state, params)`` takes each rank's local (unreduced) gradients and, a
dtype group of ``compute_metas(params)`` (no direct split) at a time:

    g        = pack(grads) in fp32, zero-padded to 1024 elements
    g_shard  = reduce_scatter(g)
    delta, m, v = adam_update(g_shard, pack(params), m, v)   (one kernel)
    updates  = all_gather(fp32 delta) unpacked to the leaves' dtypes

so ``m`` and ``v`` only ever exist shard-sized (ZeRO's memory saving).
The collectives are ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` on ``group`` (None: the default group).  More
than one rank raises, so the shard is the whole padded group and JAX's
padding to ``world * 1024``, its ``/ world`` under ``grad_average`` and
its slice of the rank's parameters are all the identity here; they come
with the sharded path across ranks, ROADMAP Queue 1 item 8, as does
JAX's ``zero_adam_plan`` (its mesh-plan contract), with ``mesh_plan``.

``learning_rate`` may be a schedule, a callable of the host step count,
read at ``count + 1`` (JAX's ``:117``).

``kernels=False`` runs the plain version of the shard update on any
device (the oracle configuration); otherwise a CUDA shard goes through
the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ...ops import multi_tensor
from ...ops.fused_optim import adam_update, adam_update_reference
from ...optimizers.fused_adam import (ScalarOrSchedule, _lr_at,
                                      bias_corrections)

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamState",
           "distributed_fused_adam"]


@dataclasses.dataclass
class DistributedFusedAdamState:
    """Step count (host int) and this rank's fp32 moment shards, one a
    dtype group."""

    count: int
    m: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class DistributedFusedAdam:
    """The hyperparameters, the process group and ``init`` / ``update``."""

    learning_rate: ScalarOrSchedule = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    group: Optional[object] = None
    grad_average: bool = True
    kernels: bool = True

    def _check_one_rank(self) -> None:
        world = dist.get_world_size(self.group)
        if world != 1:
            raise NotImplementedError(
                f"distributed_fused_adam over {world} ranks is not ported "
                f"yet (ROADMAP Queue 1 item 8); one rank is")

    def init(self, params: Sequence[torch.Tensor]
             ) -> DistributedFusedAdamState:
        """Zero fp32 moment shards, one pair a dtype group (at one rank,
        the group's padded length)."""
        self._check_one_rank()
        metas = multi_tensor.compute_metas(params)
        dev = params[0].device
        shards = tuple(torch.zeros(m.padded, dtype=torch.float32,
                                   device=dev) for m in metas)
        return DistributedFusedAdamState(
            count=0, m=shards, v=tuple(torch.zeros_like(s) for s in shards))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor],
               state: DistributedFusedAdamState,
               params: Optional[Sequence[torch.Tensor]] = None):
        """``(updates, new_state)`` from this rank's local gradients: the
        deltas in each parameter's dtype, nothing updated in place."""
        if params is None:
            raise ValueError("distributed_fused_adam requires params")
        self._check_one_rank()
        count = state.count + 1
        lr = _lr_at(self.learning_rate, count)
        bc1, bc2 = (bias_corrections(self.beta1, self.beta2, count)
                    if self.bias_correction else (1.0, 1.0))
        metas = multi_tensor.compute_metas(params)
        gbufs = multi_tensor.pack(grads, metas, torch.float32)
        pbufs = multi_tensor.pack(params, metas)
        fn = adam_update if self.kernels else adam_update_reference
        deltas, new_m, new_v = [], [], []
        for g, p, m, v in zip(gbufs, pbufs, state.m, state.v):
            g_shard = torch.empty_like(g)
            dist.reduce_scatter_tensor(g_shard, g, group=self.group)
            d, m2, v2 = fn(g_shard, p, m, v, lr=lr,
                           beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                           weight_decay=self.weight_decay,
                           bias_correction1=bc1, bias_correction2=bc2,
                           adam_w_mode=self.adam_w_mode)
            full = torch.empty_like(g_shard)
            dist.all_gather_into_tensor(full, d.float(), group=self.group)
            deltas.append(full)
            new_m.append(m2)
            new_v.append(v2)
        updates = multi_tensor.unpack_groups(deltas, metas,
                                             [p.dtype for p in params])
        return updates, DistributedFusedAdamState(count, tuple(new_m),
                                                  tuple(new_v))


def distributed_fused_adam(learning_rate: ScalarOrSchedule = 1e-3,
                           beta1: float = 0.9,
                           beta2: float = 0.999, eps: float = 1e-8,
                           weight_decay: float = 0.0,
                           adam_w_mode: bool = True,
                           bias_correction: bool = True, group=None,
                           grad_average: bool = True, *,
                           kernels: bool = True) -> DistributedFusedAdam:
    """Build the sharded transformation (ref:
    ``apex_tpu/contrib/optimizers/distributed_fused_adam.py:95``).
    ``group``: a ``torch.distributed`` process group (None: the default
    one, which must be initialised before ``init``/``update``)."""
    lr = learning_rate if callable(learning_rate) else float(learning_rate)
    return DistributedFusedAdam(lr, float(beta1),
                                float(beta2), float(eps),
                                float(weight_decay), bool(adam_w_mode),
                                bool(bias_correction), group,
                                bool(grad_average), kernels)
