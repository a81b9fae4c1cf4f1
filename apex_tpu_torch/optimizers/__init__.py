"""Fused optimizers, and :func:`apply_updates` for their ``update`` form."""
from typing import Mapping, Sequence

import numpy as np
import torch

from .fused_adagrad import FusedAdagrad, FusedAdagradState, fused_adagrad
from .fused_adam import FusedAdam, FusedAdamState, fused_adam
from .fused_lamb import FusedLAMB, FusedLAMBState, fused_lamb
from .fused_mixed_precision_lamb import (FusedMixedPrecisionLamb,
                                         MixedPrecisionLambState, MPLambInfo)
from .fused_novograd import FusedNovoGrad, FusedNovoGradState, fused_novograd
from .fused_sgd import FusedSGD, FusedSGDState, fused_sgd

__all__ = ["FusedAdam", "FusedAdamState", "fused_adam", "FusedLAMB",
           "FusedLAMBState", "fused_lamb", "FusedSGD", "FusedSGDState",
           "fused_sgd", "FusedAdagrad", "FusedAdagradState", "fused_adagrad",
           "FusedNovoGrad", "FusedNovoGradState", "fused_novograd",
           "FusedMixedPrecisionLamb", "MixedPrecisionLambState",
           "MPLambInfo", "apply_updates", "state_from_numpy"]


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]):
    """``p += u`` for each parameter, in place: the counterpart of
    ``optax.apply_updates``, ``p + u`` rounded once in ``p``'s dtype.
    Returns ``params``."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
    return params


def state_from_numpy(name: str, fields: Mapping[str, object],
                     device="cpu"):
    """The port's state of optimizer ``name`` (``fused_adam``,
    ``fused_sgd``, ``fused_adagrad``, ``fused_novograd`` or
    ``distributed_fused_adam``) from a JAX state's fields as numpy arrays
    (``state._asdict()``, the count included), on ``device``."""
    from ..contrib.optimizers.distributed_fused_adam import \
        DistributedFusedAdamState

    kinds = {"fused_adam": (FusedAdamState, ("m", "v")),
             "fused_sgd": (FusedSGDState, ("momentum",)),
             "fused_adagrad": (FusedAdagradState, ("h",)),
             "fused_novograd": (FusedNovoGradState, ("m", "v")),
             "distributed_fused_adam": (DistributedFusedAdamState,
                                        ("m", "v"))}
    if name not in kinds:
        raise ValueError(f"no state conversion for {name!r} "
                         f"(one of {sorted(kinds)})")
    cls, bufs = kinds[name]
    return cls(count=int(np.asarray(fields["count"])), **{
        k: tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                 for a in fields[k]) for k in bufs})
