"""Transformer enums: the port's own copy of ``AttnMaskType`` from
``apex_tpu/transformer/enums.py``."""
import enum

__all__ = ["AttnMaskType"]


class AttnMaskType(enum.Enum):
    padding = 1
    causal = 2
