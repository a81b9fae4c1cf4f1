"""Kernels of the port, each beside its plain PyTorch version.

Every wrapper launches its CUDA kernel on a CUDA tensor (or raises) and
runs the plain version only on a CPU tensor; :func:`launch_counts`
reads how many times each kernel was launched.
"""
from ._counts import KERNELS, launch_counts, reset_launch_counts
from .flash_attention import (flash_attention, flash_attention_with_lse,
                              mha_reference)
from .flash_decode import flash_decode, paged_attention_reference
from .layer_norm import (layer_norm, layer_norm_reference,
                         layer_norm_stats_reference, layer_norm_with_stats)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_decode", "paged_attention_reference", "layer_norm",
           "layer_norm_reference", "layer_norm_stats_reference",
           "layer_norm_with_stats"]
