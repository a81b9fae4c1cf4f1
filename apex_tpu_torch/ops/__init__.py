"""Kernels of the port, each beside its plain PyTorch version.

Every wrapper launches its CUDA kernel on a CUDA tensor (or raises) and
runs the plain version only on a CPU tensor; :func:`launch_counts`
reads how many times each kernel was launched.
"""
from ._counts import KERNELS, launch_counts, reset_launch_counts
from .flash_attention import (FlashAttentionEFunction,
                              FlashAttentionFunction, dropout_seed, e_mode,
                              flash_attention,
                              flash_attention_backward,
                              flash_attention_backward_reference,
                              flash_attention_e, flash_attention_e_backward,
                              flash_attention_e_backward_reference,
                              flash_attention_e_reference,
                              flash_attention_e_with_lse,
                              flash_attention_with_lse, mha_reference,
                              rand_keep)
from .flash_decode import (dequantize_kv, flash_decode, flash_decode_multi,
                           paged_attention_multi_reference,
                           paged_attention_reference)
from .fused_pipeline import (FlatGroup, adam_pipeline,
                             adam_pipeline_reference, flatten_params,
                             grad_norm_finite, grad_norm_finite_reference,
                             sgd_pipeline, sgd_pipeline_reference)
from .layer_norm import (FusedLayerNormFunction, fused_layer_norm,
                         layer_norm, layer_norm_backward,
                         layer_norm_backward_reference,
                         layer_norm_reference, layer_norm_stats_reference,
                         layer_norm_with_stats)
from .quant_matmul import (QuantGPTServingWeights, QuantLayerWeights,
                           dequantize_weight, is_quantized_weights,
                           quant_matmul, quant_matmul_reference,
                           quantize_weight, quantize_weights)
from .fused_optim import (adagrad_update, adagrad_update_reference,
                          adam_step, adam_step_reference, adam_update,
                          adam_update_reference, lamb_phase1,
                          lamb_phase1_reference, novograd_update,
                          novograd_update_reference, sgd_step,
                          sgd_step_reference, sgd_update,
                          sgd_update_reference)
from .moe_routing import (MoERouteDispatchFunction, RouteDispatch,
                          moe_combine, moe_route_dispatch,
                          moe_route_dispatch_reference)
from .scaled_softmax import (ScaledMaskedSoftmax,
                             ScaledUpperTriangMaskedSoftmax, causal_softmax,
                             causal_softmax_reference, masked_softmax,
                             masked_softmax_reference, scaled_masked_softmax,
                             scaled_upper_triang_masked_softmax,
                             softmax_backward, softmax_backward_reference)

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "flash_attention", "flash_attention_with_lse", "mha_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "FlashAttentionFunction", "e_mode", "rand_keep", "dropout_seed",
           "flash_attention_e", "flash_attention_e_with_lse",
           "flash_attention_e_reference",
           "flash_attention_e_backward",
           "flash_attention_e_backward_reference", "FlashAttentionEFunction",
           "flash_decode", "paged_attention_reference", "flash_decode_multi",
           "paged_attention_multi_reference", "dequantize_kv",
           "quant_matmul", "quant_matmul_reference", "quantize_weight",
           "dequantize_weight", "quantize_weights", "is_quantized_weights",
           "QuantLayerWeights", "QuantGPTServingWeights", "FlatGroup",
           "flatten_params", "adam_pipeline", "adam_pipeline_reference",
           "grad_norm_finite", "grad_norm_finite_reference",
           "layer_norm", "layer_norm_reference",
           "layer_norm_stats_reference", "layer_norm_with_stats",
           "layer_norm_backward", "layer_norm_backward_reference",
           "FusedLayerNormFunction", "fused_layer_norm",
           "scaled_upper_triang_masked_softmax", "causal_softmax",
           "causal_softmax_reference", "softmax_backward",
           "softmax_backward_reference", "ScaledUpperTriangMaskedSoftmax",
           "scaled_masked_softmax", "masked_softmax",
           "masked_softmax_reference", "ScaledMaskedSoftmax",
           "lamb_phase1", "lamb_phase1_reference", "sgd_step",
           "sgd_step_reference", "adam_step", "adam_step_reference",
           "adam_update", "adam_update_reference", "adagrad_update",
           "adagrad_update_reference", "novograd_update",
           "novograd_update_reference", "sgd_update", "sgd_update_reference",
           "sgd_pipeline", "sgd_pipeline_reference", "RouteDispatch",
           "MoERouteDispatchFunction", "moe_route_dispatch",
           "moe_route_dispatch_reference", "moe_combine"]
