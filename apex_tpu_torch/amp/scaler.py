"""Loss scaling: static scales (the bf16 O4/O5 regime) and the dynamic
schedule (the fp16 O1/O2 regime).

Port of ``apex_tpu/amp/scaler.py:25-176, 219-242`` — ``ScalerState``,
``init``, ``scale_loss``, ``update``, ``state_dict`` and
``load_state_dict`` — with the state on the host: the scale and the
counters are Python numbers, and the caller hands :func:`update` the
step's finite flag, read from the device once per step (the reference
Apex's ``update_scale`` reads its overflow flag with ``.item()`` the
same way).  Dynamic schedule, as the JAX package and apex: init at 2^16;
on an overflow the scale halves and the growth tracker resets; after
``growth_interval`` (2000) finite steps in a row the scale doubles; the
result is clipped to [``min_loss_scale``, ``max_loss_scale``] = [1,
2^24] after the backoff or growth.  A static scale never moves; a
non-finite step only counts as skipped.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

__all__ = ["DYNAMIC_INIT_SCALE", "GROWTH_FACTOR", "BACKOFF_FACTOR",
           "GROWTH_INTERVAL", "ScalerState", "init", "scale_loss", "update",
           "state_dict", "load_state_dict"]

DYNAMIC_INIT_SCALE = 2.0 ** 16
GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
GROWTH_INTERVAL = 2000


@dataclasses.dataclass(frozen=True)
class ScalerState:
    """Host-side scaler state: the scale, the finite steps in a row
    since the last growth or overflow, the skipped steps, and the static
    configuration."""

    loss_scale: float = 1.0
    growth_tracker: int = 0
    steps_skipped: int = 0
    dynamic: bool = False
    min_loss_scale: float = 1.0
    max_loss_scale: float = 2.0 ** 24
    growth_interval: int = GROWTH_INTERVAL


def init(loss_scale: Union[str, float, int, None] = "dynamic",
         min_loss_scale: float = 1.0,
         max_loss_scale: float = 2.0 ** 24) -> ScalerState:
    """``"dynamic"`` for the dynamic schedule from 2^16, a number for a
    static scale, None for 1.0 (the bf16 regime)."""
    dynamic = loss_scale == "dynamic"
    scale = DYNAMIC_INIT_SCALE if dynamic else float(loss_scale or 1.0)
    return ScalerState(loss_scale=scale, dynamic=dynamic,
                       min_loss_scale=float(min_loss_scale),
                       max_loss_scale=float(max_loss_scale))


def scale_loss(loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
    """``loss.float() * loss_scale``."""
    return loss.float() * state.loss_scale


def update(state: ScalerState, grads_finite: bool) -> ScalerState:
    """Advance the state by one step's finite flag
    (``apex_tpu/amp/scaler.py:150-176``): backoff or growth first, the
    clip to [min, max] after."""
    finite = bool(grads_finite)
    skipped = state.steps_skipped + (0 if finite else 1)
    if not state.dynamic:
        return dataclasses.replace(state, steps_skipped=skipped)
    tracker = state.growth_tracker + 1 if finite else 0
    grow = tracker >= state.growth_interval
    if finite:
        scale = state.loss_scale * GROWTH_FACTOR if grow else state.loss_scale
    else:
        scale = state.loss_scale * BACKOFF_FACTOR
    scale = min(max(scale, state.min_loss_scale), state.max_loss_scale)
    return dataclasses.replace(state, loss_scale=scale,
                               growth_tracker=0 if grow else tracker,
                               steps_skipped=skipped)


def state_dict(state: ScalerState) -> dict:
    """Serializable view (the JAX ``state_dict``'s keys)."""
    return dataclasses.asdict(state)


def load_state_dict(d: dict) -> ScalerState:
    """Inverse of :func:`state_dict`, with the JAX defaults for missing
    optional keys."""
    return ScalerState(
        loss_scale=float(d["loss_scale"]),
        growth_tracker=int(d["growth_tracker"]),
        steps_skipped=int(d.get("steps_skipped", 0)),
        dynamic=bool(d["dynamic"]),
        min_loss_scale=float(d.get("min_loss_scale", 1.0)),
        max_loss_scale=float(d.get("max_loss_scale", 2.0 ** 24)),
        growth_interval=int(d.get("growth_interval", GROWTH_INTERVAL)))
