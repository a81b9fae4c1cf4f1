"""Loss scaling: static scales (the bf16 O4/O5 regime).

Port of ``apex_tpu/amp/scaler.py``'s state, ``init``, ``scale_loss`` and
``update`` for a static scale: the scale never moves and a step is
never skipped for an overflow (apex's static ``LossScaler``).  The
dynamic schedule (backoff on overflow, growth every 2000 clean steps,
its tracker and bounds) comes with the O2 slice; ``init("dynamic")``
raises until then.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

__all__ = ["ScalerState", "init", "scale_loss", "update"]


@dataclasses.dataclass(frozen=True)
class ScalerState:
    """Host-side state of a static scaler."""

    loss_scale: float = 1.0
    steps_skipped: int = 0


def init(loss_scale: Union[str, float, int, None] = None) -> ScalerState:
    """A static scaler at ``loss_scale`` (None = 1.0, the bf16
    regime)."""
    if loss_scale == "dynamic":
        raise NotImplementedError(
            "dynamic loss scaling comes with the O2 slice of the port")
    return ScalerState(loss_scale=float(loss_scale or 1.0))


def scale_loss(loss: torch.Tensor, state: ScalerState) -> torch.Tensor:
    """``loss.float() * loss_scale``."""
    return loss.float() * state.loss_scale


def update(state: ScalerState, grads_finite: bool) -> ScalerState:
    """The static schedule: the scale holds; a non-finite step counts as
    skipped."""
    return dataclasses.replace(
        state, steps_skipped=state.steps_skipped + (0 if grads_finite else 1))
