"""Standalone GPT serving entry point of the port.

Counterpart of ``apex_tpu/testing/standalone_gpt.py``'s ``serve_smoke``
and its ``--serve`` CLI, the port's normal entry point::

    python -m apex_tpu_torch.testing.standalone_gpt --serve
    python -m apex_tpu_torch.testing.standalone_gpt --serve --model tiny \
        --device cpu --requests 4 --new-tokens 4

The default model is GPT-345M's width (vocab 50304, hidden 1024, 24
layers, 16 heads, max_seq 1024) under O5 (bf16), with seeded random
weights: no checkpoint is read.  The run serves ``--requests`` seeded
prompts through the continuous-batching engine and prints one
``SERVE_DONE`` line.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..amp import get_policy
from ..serving import (BucketLadder, Request, ServingEngine,
                       ServingModelConfig, default_cache_config,
                       init_serving_weights)

__all__ = ["MODELS", "model_config", "seeded_prompts", "serve_smoke",
           "main"]

# model presets: name -> ServingModelConfig geometry
MODELS = {
    # GPT-345M (Megatron's 345M GPT-2 medium), the width bench.py runs
    "gpt345m": dict(vocab_size=50304, hidden_size=1024, num_heads=16,
                    num_layers=24, max_seq=1024),
    # the CPU smoke size
    "tiny": dict(vocab_size=256, hidden_size=128, num_heads=2,
                 num_layers=2, max_seq=128),
}


def model_config(model: str = "gpt345m", *,
                 policy: str = "O5") -> ServingModelConfig:
    """The preset's :class:`ServingModelConfig` in the amp ``policy``'s
    model dtype."""
    return ServingModelConfig(dtype=get_policy(policy).param_dtype,
                              **MODELS[model])


def seeded_prompts(lengths: Sequence[int], vocab: int,
                   seed: int) -> List[List[int]]:
    """Token prompts of the given lengths, drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, vocab, int(n))]
            for n in lengths]


def serve_smoke(num_requests: int = 8, *, model: str = "gpt345m",
                policy: str = "O5", max_new_tokens: int = 32,
                prompt_lengths: Optional[Sequence[int]] = None,
                min_prompt: int = 64, max_prompt: int = 700,
                seed: int = 0, device=None):
    """Build the model and engine on ``device`` (cuda unless the CPU is
    asked for), serve ``num_requests`` seeded prompts, and return
    ``(summary, engine)``; ``engine.done`` holds every request with its
    ``prompt`` and ``out_tokens``.

    Prompt lengths are drawn from ``seed`` in ``[min_prompt,
    max_prompt]`` (clipped so prompt + ``max_new_tokens`` fits the
    ladder span and ``max_seq``), unless ``prompt_lengths`` names
    them."""
    dev = resolve_device(device)
    cfg = model_config(model, policy=policy)
    cache_cfg = default_cache_config(cfg)
    ladder = BucketLadder()
    weights = init_serving_weights(cfg, seed=seed, device=dev)
    engine = ServingEngine(weights, cfg, cache_cfg, ladder=ladder,
                           device=dev)
    if prompt_lengths is None:
        span = min(cfg.max_seq,
                   ladder.max_pages * cache_cfg.block_size)
        hi = max(1, min(max_prompt, span - max_new_tokens))
        lo = max(1, min(min_prompt, hi))
        rng = np.random.RandomState(seed + 1)
        prompt_lengths = [int(n) for n in rng.randint(lo, hi + 1,
                                                      num_requests)]
    prompts = seeded_prompts(prompt_lengths, cfg.vocab_size, seed + 2)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=f"req{i:03d}", prompt=p,
                              max_new_tokens=max_new_tokens))
    summary = engine.run()
    return summary, engine


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.testing.standalone_gpt",
        description="Serve seeded prompts through the port's engine.")
    p.add_argument("--serve", action="store_true", required=True,
                   help="run the continuous-batching serve smoke")
    p.add_argument("--model", default="gpt345m", choices=sorted(MODELS))
    p.add_argument("--policy", default="O5",
                   help="amp opt level: O5 serves in bf16, O0 in fp32")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--min-prompt", type=int, default=64)
    p.add_argument("--max-prompt", type=int, default=700)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    s, eng = serve_smoke(
        args.requests, model=args.model, policy=args.policy,
        max_new_tokens=args.new_tokens, min_prompt=args.min_prompt,
        max_prompt=args.max_prompt, seed=args.seed, device=args.device)
    print(f"SERVE_DONE requests={s.requests_done} "
          f"tokens={s.tokens_generated} tokens_s={s.tokens_per_sec} "
          f"p50_ms={s.latency_p50_ms} p99_ms={s.latency_p99_ms} "
          f"ttft_p50_ms={s.ttft_p50_ms} ttft_p99_ms={s.ttft_p99_ms} "
          f"itl_p50_ms={s.itl_p50_ms} itl_p99_ms={s.itl_p99_ms} "
          f"steps={s.decode_steps} device={s.device} "
          f"digest={eng.tokens_digest()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
