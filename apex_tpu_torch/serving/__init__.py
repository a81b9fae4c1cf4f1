"""Serving: paged KV cache (float or int8), the GPT prefill/decode/extend
forward over float, Q8 or MoE weights, and the continuous-batching engine
with its fast path — speculative decode, chunked prefill, copy-on-write
prefix sharing (port of ``apex_tpu.serving``'s single-device path)."""
from .engine import (BucketLadder, Request, ServeSummary, ServingEngine,
                     default_cache_config, parse_ladder)
from ..ops.quant_matmul import (QuantGPTServingWeights, QuantLayerWeights,
                                is_quantized_weights, quantize_weights)
from .kv_cache import (DUMP_BLOCK, CachePoolExhausted, KVCacheConfig,
                       KVCacheManager, PagedKVCache, PrefixMatch, init_cache,
                       prefix_chain_keys, quantize_kv_rows, write_prefill_kv,
                       write_token_kv)
from .ep import expand_moe_weights
from .model import (GPTServingWeights, LayerWeights, MoELayerWeights,
                    ServingModelConfig,
                    copy_cache_block, gpt_decode_step, gpt_extend_step,
                    gpt_prefill_step, gpt_sequence_logits)
from .resilience import SpeculationGovernor
from .weights import init_serving_weights, serving_weights_from_numpy

__all__ = ["BucketLadder", "Request", "ServeSummary", "ServingEngine",
           "default_cache_config", "parse_ladder", "DUMP_BLOCK",
           "CachePoolExhausted", "KVCacheConfig",
           "KVCacheManager", "PagedKVCache", "PrefixMatch", "init_cache",
           "prefix_chain_keys", "quantize_kv_rows", "write_prefill_kv",
           "write_token_kv", "GPTServingWeights", "QuantGPTServingWeights",
           "QuantLayerWeights", "quantize_weights", "is_quantized_weights",
           "LayerWeights", "MoELayerWeights", "expand_moe_weights",
           "ServingModelConfig", "copy_cache_block",
           "gpt_decode_step", "gpt_extend_step", "gpt_prefill_step",
           "gpt_sequence_logits", "SpeculationGovernor",
           "init_serving_weights", "serving_weights_from_numpy"]
