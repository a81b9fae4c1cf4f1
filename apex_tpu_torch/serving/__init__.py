"""Serving: paged KV cache, the GPT prefill/decode forward, and the
continuous-batching engine (port of ``apex_tpu.serving``'s default
single-device path)."""
from .engine import (BucketLadder, Request, ServeSummary, ServingEngine,
                     default_cache_config, parse_ladder)
from .kv_cache import (DUMP_BLOCK, CachePoolExhausted, KVCacheConfig,
                       KVCacheManager, PagedKVCache, init_cache,
                       write_prefill_kv, write_token_kv)
from .model import (GPTServingWeights, LayerWeights, ServingModelConfig,
                    gpt_decode_step, gpt_prefill_step, gpt_sequence_logits)
from .weights import init_serving_weights, serving_weights_from_numpy

__all__ = ["BucketLadder", "Request", "ServeSummary", "ServingEngine",
           "default_cache_config", "parse_ladder", "DUMP_BLOCK",
           "CachePoolExhausted", "KVCacheConfig", "KVCacheManager",
           "PagedKVCache", "init_cache", "write_prefill_kv",
           "write_token_kv", "GPTServingWeights", "LayerWeights",
           "ServingModelConfig", "gpt_decode_step", "gpt_prefill_step",
           "gpt_sequence_logits", "init_serving_weights",
           "serving_weights_from_numpy"]
