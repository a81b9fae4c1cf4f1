"""Kernels of the port, each beside its plain PyTorch version.

Every wrapper launches its CUDA kernel on a CUDA tensor (or raises) and
runs the plain version only on a CPU tensor; :func:`launch_counts`
reads how many times each kernel was launched.
"""
from ._counts import KERNELS, launch_counts, reset_launch_counts
from .flash_attention import (FlashAttentionEFunction, flash_attention,
                              flash_attention_e, flash_attention_e_backward,
                              flash_attention_e_backward_reference,
                              flash_attention_e_reference,
                              flash_attention_e_with_lse,
                              flash_attention_with_lse, mha_reference)
from .flash_decode import flash_decode, paged_attention_reference
from .fused_pipeline import (FlatGroup, adam_pipeline,
                             adam_pipeline_reference, flatten_params)
from .layer_norm import (FusedLayerNormFunction, fused_layer_norm,
                         layer_norm, layer_norm_backward,
                         layer_norm_backward_reference,
                         layer_norm_reference, layer_norm_stats_reference,
                         layer_norm_with_stats)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_attention_e", "flash_attention_e_with_lse",
           "flash_attention_e_reference",
           "flash_attention_e_backward",
           "flash_attention_e_backward_reference", "FlashAttentionEFunction",
           "flash_decode", "paged_attention_reference", "FlatGroup",
           "flatten_params", "adam_pipeline", "adam_pipeline_reference",
           "layer_norm", "layer_norm_reference",
           "layer_norm_stats_reference", "layer_norm_with_stats",
           "layer_norm_backward", "layer_norm_backward_reference",
           "FusedLayerNormFunction", "fused_layer_norm"]
