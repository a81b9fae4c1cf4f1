"""Serving resilience: the speculative-decode governor.

Port of ``apex_tpu/serving/resilience.py``'s ``SpeculationGovernor``.
The request journal, the shed policy and supervised replay are later
slices.
"""
from __future__ import annotations

__all__ = ["SpeculationGovernor"]


class SpeculationGovernor:
    """Turn speculation off after sustained verify mismatch.

    Observes every speculative tick's (proposed, accepted) pair; when
    ``window`` consecutive ticks each land below ``min_accept``
    acceptance, :meth:`observe` returns True once and the engine stops
    speculating for the rest of the run.  Speculative greedy and plain
    greedy emit the same tokens, so degrading changes no output; a draft
    that proposes garbage costs K draft steps a tick for nothing."""

    def __init__(self, *, min_accept: float = 0.05, window: int = 4):
        if not 0.0 <= min_accept <= 1.0:
            raise ValueError(f"min_accept {min_accept} not in [0, 1]")
        if window < 1:
            raise ValueError(f"window {window} must be >= 1")
        self.min_accept = float(min_accept)
        self.window = int(window)
        self.low_streak = 0
        self.tripped = False

    def observe(self, proposed: int, accepted: int) -> bool:
        """Feed one speculative tick; True exactly once, on the tick
        that trips the governor."""
        if self.tripped or proposed <= 0:
            return False
        if accepted / proposed < self.min_accept:
            self.low_streak += 1
        else:
            self.low_streak = 0
        if self.low_streak >= self.window:
            self.tripped = True
            return True
        return False
