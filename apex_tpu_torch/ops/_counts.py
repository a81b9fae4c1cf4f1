"""Launch counts of the port's kernels.

Each wrapper adds one to its kernel's count right after the launch
succeeds, and nowhere else: the plain PyTorch versions never count.
A caller resets the counts just before the path it wants to prove and
reads them just after (``chip_smoke.py`` does this around the serve and
around each train step).
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("layer_norm", "flash_attention", "flash_decode", "layer_norm_bwd",
           "flash_attention_e", "flash_attention_e_bwd",
           "fused_adam_pipeline", "scaled_softmax_causal_fwd",
           "scaled_softmax_bwd", "norm_finite")

_COUNTS: Dict[str, int] = {name: 0 for name in KERNELS}


def bump(name: str) -> None:
    _COUNTS[name] += 1


def reset_launch_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_COUNTS)
