"""Standalone GPT: the port's serving and training entry points.

Counterpart of ``apex_tpu/testing/standalone_gpt.py``: the model
(``GPTEmbedding``, ``GPTModel``, ``gpt_loss``), ``serve_smoke`` with its
``--serve`` CLI, and ``train_smoke`` with ``--train``::

    python -m apex_tpu_torch.testing.standalone_gpt --serve
    python -m apex_tpu_torch.testing.standalone_gpt --train
    python -m apex_tpu_torch.testing.standalone_gpt --train --policy O2
    python -m apex_tpu_torch.testing.standalone_gpt --serve --model tiny \
        --device cpu --requests 4 --new-tokens 4
    python -m apex_tpu_torch.testing.standalone_gpt --train --policy O2 \
        --model tiny --device cpu --steps 4

The default model is GPT-345M's width (vocab 50304, hidden 1024, 24
layers, 16 heads, max_seq 1024) with seeded random weights: no
checkpoint is read.  ``--serve`` serves ``--requests`` seeded prompts
through the continuous-batching engine at O5 (bf16) or O0 and prints
one ``SERVE_DONE`` line.  ``--train`` takes ``--steps`` optimizer steps
on one seeded batch (seq 1024, batch 8 at GPT-345M) with
``fused_adam(1e-4)`` and no dropout, in one of the JAX package's two
train recipes (:data:`TRAIN_RECIPES`), and prints one ``TRAIN_DONE``
line: ``O5`` is ``bench.py``'s ``bench_gpt345m`` (flash attention, bf16,
a static scale of 1); ``O2`` is ``make_smoke_setup``'s route
(``use_flash=False``: materialized scores through the fused causal
softmax; fp16 parameters and compute, fp32 masters, a dynamic loss
scale from 2^16).  Both run on the card unless ``--device cpu`` is
asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import amp, resolve_device
from ..amp import get_policy
from ..contrib.xentropy import softmax_cross_entropy_loss
from ..optimizers import fused_adam
from ..serving import (BucketLadder, Request, ServingEngine,
                       ServingModelConfig, default_cache_config,
                       init_serving_weights)
from ..transformer import ParallelTransformer
from ..transformer.tensor_parallel import VocabParallelEmbedding

__all__ = ["MODELS", "TRAIN_RECIPES", "model_config", "seeded_prompts", "serve_smoke",
           "GPTEmbedding", "GPTModel", "gpt_loss", "gpt_params_from_numpy",
           "TrainSetup", "make_train_setup", "train_step", "TrainResult",
           "train_smoke", "masters_digest", "main"]

# model presets: the geometry (the ServingModelConfig fields) and the
# training batch (``seq`` tokens by ``batch`` rows)
MODELS = {
    # GPT-345M (Megatron's 345M GPT-2 medium), the width and the batch
    # bench.py's bench_gpt345m runs
    "gpt345m": dict(vocab_size=50304, hidden_size=1024, num_heads=16,
                    num_layers=24, max_seq=1024, seq=1024, batch=8),
    # the CPU smoke size
    "tiny": dict(vocab_size=256, hidden_size=128, num_heads=2,
                 num_layers=2, max_seq=128, seq=64, batch=2),
}
_TRAIN_KEYS = ("seq", "batch")
# the train recipes, by amp policy: O5 is bench.py's bench_gpt345m
# (flash attention, bf16, static scale 1); O2 is make_smoke_setup's route
# (materialized scores and the fused softmax, fp16, dynamic scale).  The
# compute dtype is the policy's model dtype.
TRAIN_RECIPES = {"O5": dict(use_flash=True), "O2": dict(use_flash=False)}
TRAIN_LR = 1e-4


def model_config(model: str = "gpt345m", *,
                 policy: str = "O5") -> ServingModelConfig:
    """The preset's :class:`ServingModelConfig` in the amp ``policy``'s
    model dtype."""
    geometry = {k: v for k, v in MODELS[model].items()
                if k not in _TRAIN_KEYS}
    return ServingModelConfig(dtype=get_policy(policy).param_dtype,
                              **geometry)


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


# --- the model ---------------------------------------------------------

class GPTEmbedding(nn.Module):
    """Token + learned position embeddings (ref:
    ``apex_tpu/testing/standalone_gpt.py:69-102``); ``attend`` is the
    tied LM head.  Both tables are ``embedding`` parameters, as in the
    flax tree."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_sequence_length: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.word_embeddings = VocabParallelEmbedding(
            vocab_size, hidden_size, dtype=dtype, device=device)
        self.position_embeddings = VocabParallelEmbedding(
            max_sequence_length, hidden_size, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(tokens.shape[-1], device=tokens.device)
        return self.word_embeddings(tokens) + self.position_embeddings(pos)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings.attend(x)


class GPTModel(nn.Module):
    """Embedding -> transformer -> tied head, returning (b, s, vocab)
    logits in the compute ``dtype`` (ref:
    ``apex_tpu/testing/standalone_gpt.py:105-149``), without dropout.
    Parameters are fp32 until :func:`apex_tpu_torch.amp.initialize` casts them;
    ``kernels=False`` runs every kernel's plain version (the oracle
    configuration)."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 num_attention_heads: int, max_sequence_length: int, *,
                 use_flash: bool = True, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding = GPTEmbedding(vocab_size, hidden_size,
                                      max_sequence_length, dtype=dtype,
                                      device=device)
        self.transformer = ParallelTransformer(
            num_layers, hidden_size, num_attention_heads,
            use_flash=use_flash, kernels=kernels, dtype=dtype,
            device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "GPTModel":
        """Seeded random weights from ``generator``, drawn in module
        order: embeddings normal(0, 0.02), kernels normal with variance
        1/fan_in, biases zero, LayerNorm ones/zeros."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding.attend(self.transformer(self.embedding(tokens)))


def gpt_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of the fp32 per-token cross-entropy (``half_to_float``)."""
    return softmax_cross_entropy_loss(logits, labels, 0.0, True).mean()


def gpt_params_from_numpy(flax_params: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """A state dict for :class:`GPTModel` from the JAX ``GPTModel``'s
    parameter tree as numpy (``jax.tree.map(np.asarray, params)``): the
    nested names joined by dots are the port's parameter names
    (``embedding.word_embeddings.embedding``,
    ``transformer.layer_0.self_attention.query_key_value.kernel``, ...);
    the layouts are the same."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                walk(val, name + ".")
            else:
                out[name] = torch.from_numpy(np.array(val))

    walk(flax_params, "")
    return out


# --- training ------------------------------------------------------------

@dataclasses.dataclass
class TrainSetup:
    """A model ready to train: the cast module, its amp optimizer, one
    seeded batch, and the step's size."""

    model: GPTModel
    amp_opt: Any
    tokens: torch.Tensor
    labels: torch.Tensor
    n_params: int
    flops_per_step: float

    @property
    def tokens_per_step(self) -> int:
        return self.tokens.numel()


def make_train_setup(model: str = "gpt345m", *, policy: str = "O5",
                     seed: int = 0, kernels: bool = True,
                     device=None) -> TrainSetup:
    """Build the preset's GPT from seeded weights on ``device`` (cuda
    unless the CPU is asked for) in the ``policy``'s train recipe
    (:data:`TRAIN_RECIPES`), ``amp.initialize`` it with
    ``fused_adam(TRAIN_LR)`` at that policy, and draw one batch (labels =
    tokens shifted by one) from the same ``seed``.  ``kernels=False``
    runs every kernel's plain version, on the same weights and data."""
    if policy not in TRAIN_RECIPES:
        raise ValueError(f"the train recipes are {sorted(TRAIN_RECIPES)}, "
                         f"not {policy!r}")
    dev = resolve_device(device)
    geo = MODELS[model]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    net = GPTModel(geo["vocab_size"], geo["hidden_size"], geo["num_layers"],
                   geo["num_heads"], geo["max_seq"], kernels=kernels,
                   dtype=get_policy(policy).param_dtype, device=dev,
                   **TRAIN_RECIPES[policy]).reset_parameters(g)
    b, s = geo["batch"], geo["seq"]
    tokens = torch.randint(0, geo["vocab_size"], (b, s), generator=g,
                           device=dev)
    n_params = sum(p.numel() for p in net.parameters())
    opt = fused_adam(TRAIN_LR, kernels=kernels)
    net, amp_opt = amp.initialize(net, opt, opt_level=policy)
    # bench.py's model FLOPs: 6 N per token plus the attention scores
    flops = 6.0 * n_params * b * s \
        + 12.0 * geo["num_layers"] * geo["hidden_size"] * s * s * b
    return TrainSetup(net, amp_opt, tokens, torch.roll(tokens, -1, dims=-1),
                      n_params, flops)


def train_step(setup: TrainSetup):
    """One step: zero the flat grads, forward, the scaled loss's
    backward, and the fused optimizer sweeps.  Returns the (unscaled)
    loss, still on the device, and the step's ``StepInfo``."""
    setup.amp_opt.zero_grad()
    loss = gpt_loss(setup.model(setup.tokens), setup.labels)
    setup.amp_opt.scale_loss(loss).backward()
    info = setup.amp_opt.apply_gradients()
    return loss.detach(), info


@dataclasses.dataclass
class TrainResult:
    """What :func:`train_smoke` ran and measured.  ``step_ms`` is the
    host wall of each step, through the host sync that reads its loss;
    ``median_ms`` the median of steps 3 on (all steps when fewer than
    three).  ``steps`` holds each step's ``(grads_finite, loss_scale,
    steps_skipped, grad_norm)`` after its update (``grad_norm`` None
    when the step did not check its gradients)."""

    losses: List[float]
    step_ms: List[float]
    device: str
    setup: TrainSetup
    steps: List[Tuple[bool, float, int, Optional[float]]]

    @property
    def median_ms(self) -> float:
        tail = self.step_ms[2:] if len(self.step_ms) > 2 else self.step_ms
        return float(np.median(tail))

    @property
    def tokens_per_sec(self) -> float:
        return self.setup.tokens_per_step / (self.median_ms / 1e3)

    @property
    def tflops_per_sec(self) -> float:
        return self.setup.flops_per_step / (self.median_ms / 1e3) / 1e12


def masters_digest(amp_opt) -> str:
    """sha256 (first 16 hex digits) of the fp32 master buffers, in group
    order."""
    h = hashlib.sha256()
    for g in amp_opt.groups:
        h.update(g.master.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def train_smoke(steps: int = 8, *, model: str = "gpt345m",
                policy: str = "O5", seed: int = 0, kernels: bool = True,
                device=None) -> TrainResult:
    """:func:`make_train_setup`, then ``steps`` :func:`train_step` s on
    its one batch, each timed through the read of its loss."""
    setup = make_train_setup(model, policy=policy, seed=seed,
                             kernels=kernels, device=device)
    losses, step_ms, infos = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, info = train_step(setup)
        losses.append(float(loss))                # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        infos.append((info.grads_finite, info.loss_scale,
                      info.steps_skipped, info.grad_norm))
    return TrainResult(losses, step_ms, str(setup.tokens.device), setup,
                       infos)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.testing.standalone_gpt",
        description="Serve seeded prompts through the port's engine, or "
                    "train the port's GPT for a few steps.")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--serve", action="store_true",
                      help="run the continuous-batching serve smoke")
    mode.add_argument("--train", action="store_true",
                      help="run the mixed-precision train smoke")
    p.add_argument("--model", default="gpt345m", choices=sorted(MODELS))
    p.add_argument("--policy", default="O5",
                   help="amp opt level; serve: O5 (bf16) or O0 (fp32); "
                        "train: O5 (bf16, flash) or O2 (fp16, fused "
                        "softmax, dynamic loss scale)")
    p.add_argument("--steps", type=int, default=8,
                   help="train: optimizer steps")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--min-prompt", type=int, default=64)
    p.add_argument("--max-prompt", type=int, default=700)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.train:
        if args.policy not in TRAIN_RECIPES:
            parser.error(f"--train runs at {sorted(TRAIN_RECIPES)}, not "
                         f"{args.policy}")
        r = train_smoke(args.steps, model=args.model, policy=args.policy,
                        seed=args.seed, device=args.device)
        _, scale, skipped, _ = r.steps[-1]
        print(f"TRAIN_DONE policy={args.policy} steps={len(r.losses)} "
              f"loss_first={r.losses[0]:.6f} loss_last={r.losses[-1]:.6f} "
              f"skipped={skipped} scale={scale:g} "
              f"step_ms_p50={r.median_ms:.3f} "
              f"tokens_s={r.tokens_per_sec:.1f} "
              f"tflops={r.tflops_per_sec:.3f} params={r.setup.n_params} "
              f"device={r.device} digest={masters_digest(r.setup.amp_opt)}",
              flush=True)
        return 0
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
