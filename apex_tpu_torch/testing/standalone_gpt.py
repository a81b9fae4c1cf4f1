"""Standalone GPT: the port's serving and training entry points.

Counterpart of ``apex_tpu/testing/standalone_gpt.py``: the model
(``GPTEmbedding``, ``GPTModel``, ``gpt_loss``), ``serve_smoke`` with its
``--serve`` CLI, and ``train_smoke`` with ``--train``::

    python -m apex_tpu_torch.testing.standalone_gpt --serve
    python -m apex_tpu_torch.testing.standalone_gpt --train
    python -m apex_tpu_torch.testing.standalone_gpt --train --policy O2
    python -m apex_tpu_torch.testing.standalone_gpt --train --policy O4
    python -m apex_tpu_torch.testing.standalone_gpt --train --policy O1
    python -m apex_tpu_torch.testing.standalone_gpt --train \
        --model gpt345m_s2048
    python -m apex_tpu_torch.testing.standalone_gpt --train \
        --attention-dropout 0.1
    python -m apex_tpu_torch.testing.standalone_gpt --serve --speculate-k 2
    python -m apex_tpu_torch.testing.standalone_gpt --serve --speculate-k 2 \
        --draft truncated
    python -m apex_tpu_torch.testing.standalone_gpt --serve --prefill-chunk 32
    python -m apex_tpu_torch.testing.standalone_gpt --serve --prefix-share
    python -m apex_tpu_torch.testing.standalone_gpt --serve --policy Q8 \
        --kv-dtype int8
    python -m apex_tpu_torch.testing.standalone_gpt --serve --moe-experts 8
    python -m apex_tpu_torch.testing.standalone_gpt --serve --moe-experts 8 \
        --moe-capacity-factor 1.25
    python -m apex_tpu_torch.testing.standalone_gpt --serve --model tiny \
        --device cpu --requests 4 --new-tokens 4
    python -m apex_tpu_torch.testing.standalone_gpt --train --policy O2 \
        --model tiny --device cpu --steps 4

The default model is GPT-345M's width (vocab 50304, hidden 1024, 24
layers, 16 heads, max_seq 1024) with seeded random weights: no
checkpoint is read.  ``--serve`` serves ``--requests`` seeded prompts
through the continuous-batching engine at O5 (bf16), O0, or Q8 (O5 with
int8 weight-only layer matmuls), with the KV cache stored as
``--kv-dtype`` (the model's dtype, bf16, or int8 with per-row scales),
and prints one ``SERVE_DONE`` line; ``--speculate-k``, ``--prefill-chunk`` and
``--prefix-share`` turn on the engine's fast path (speculative decode
with a ``--draft``, chunked prefill, copy-on-write prefix sharing);
``--moe-experts E`` makes every layer's MLP a Switch top-1 mixture of E
experts (:func:`moe_serving_weights`) routed through row 18's kernel, with
``--moe-capacity-factor`` (8.0, JAX's serve: nothing drops at E = 8).
``--train`` takes ``--steps`` optimizer steps on one seeded batch (seq
1024, batch 8 at GPT-345M; seq 2048, batch 4 at ``gpt345m_s2048``, the
long-sequence row) with ``fused_adam(1e-4)``, in one of the JAX
package's train recipes (:data:`TRAIN_RECIPES`), without dropout
unless ``--attention-dropout`` / ``--hidden-dropout`` set rates (the
embedding's is the hidden rate, as in JAX; ``--attention-dropout 0.1``
alone is ``bench.py``'s ``gpt2_345m_dropout``, a fresh seed for every
layer every step), and prints one ``TRAIN_DONE`` line: ``O5`` is ``bench.py``'s ``bench_gpt345m`` (flash attention, bf16,
a static scale of 1); ``O2`` is ``make_smoke_setup``'s route
(``use_flash=False``: materialized scores through the fused causal
softmax; fp16 parameters and compute, fp32 masters, a dynamic loss
scale from 2^16).  The policies without master weights: ``O4`` (the
fork's bf16 op-level level) and ``O1`` (Apex's fp16 one, a dynamic loss
scale from 2^16) keep the model fp32 and run the forward and loss under
``amp.autocast`` (matmuls on bf16/fp16 operands with fp32 results, flash
attention in bf16/fp16, layer norm in fp32), through flash attention as
O5 does; ``O0`` (fp32) and ``O3`` (fp16 parameters, a static scale of 1)
take O2's materialized scores.  All four step the parameters themselves
on amp's staged route.  All run on the card unless ``--device cpu`` is
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
from ..serving import (BucketLadder, GPTServingWeights, Request,
                       ServingEngine, ServingModelConfig,
                       default_cache_config, expand_moe_weights,
                       init_serving_weights, quantize_weights)
from ..serving.kv_cache import KV_DTYPES
from ..transformer import DropoutRNG, ParallelTransformer
from ..transformer.layers import dropout, dropout_rng
from ..transformer.tensor_parallel import VocabParallelEmbedding

__all__ = ["MODELS", "TRAIN_RECIPES", "DRAFTS", "model_config", "seeded_prompts",
           "truncated_draft", "moe_serving_weights", "serve_smoke",
           "GPTEmbedding", "GPTModel", "gpt_loss", "gpt_params_from_numpy",
           "TrainSetup", "make_train_setup", "model_flops", "forward_backward",
           "train_step",
           "TrainResult",
           "train_smoke", "masters_digest", "main"]

# model presets: the geometry (the ServingModelConfig fields) and the
# training batch (``seq`` tokens by ``batch`` rows)
MODELS = {
    # GPT-345M (Megatron's 345M GPT-2 medium), the width and the batch
    # bench.py's bench_gpt345m runs
    "gpt345m": dict(vocab_size=50304, hidden_size=1024, num_heads=16,
                    num_layers=24, max_seq=1024, seq=1024, batch=8),
    # the same model at seq 2048, batch 4: bench.py's gpt2_345m_s2048
    # (bench_gpt345m(seq=2048, batch=4)), the model-level long sequence,
    # where every layer's attention is past the JAX package's one-block E
    # limit (padded s > 1024: the blocked walk, rows 11 and 13)
    "gpt345m_s2048": dict(vocab_size=50304, hidden_size=1024, num_heads=16,
                          num_layers=24, max_seq=2048, seq=2048, batch=4),
    # the CPU smoke size
    "tiny": dict(vocab_size=256, hidden_size=128, num_heads=2,
                 num_layers=2, max_seq=128, seq=64, batch=2),
}
_TRAIN_KEYS = ("seq", "batch")
# the train recipes, by amp policy: O5 is bench.py's bench_gpt345m
# (flash attention, bf16, static scale 1); O2 is make_smoke_setup's route
# (materialized scores and the fused softmax, fp16, dynamic scale).  The
# model dtype is the policy's (fp32 for O0, O1 and O4; fp16 for O3).  O4
# and O1 take O5's flash route under amp.autocast; O0 and O3 take
# make_smoke_setup's route, as O2
TRAIN_RECIPES = {"O5": dict(use_flash=True), "O2": dict(use_flash=False),
                 "O4": dict(use_flash=True), "O1": dict(use_flash=True),
                 "O0": dict(use_flash=False), "O3": dict(use_flash=False)}
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


# the draft models serve_smoke builds for speculative decoding
DRAFTS = ("self", "truncated")


def truncated_draft(weights: GPTServingWeights, cfg: ServingModelConfig,
                    num_layers: Optional[int] = None):
    """A draft made of the target's first ``num_layers`` layers with its
    embeddings, final LayerNorm and tied head: ``(weights, cfg)``.  The
    tensors are the target's own (nothing is copied).  ``num_layers``
    defaults to all but the last two (at least one): with seeded random
    weights at GPT-345M width, drafts of 8 layers or fewer accept no
    proposal and 22 of 24 accept about a third (PERF.md)."""
    if num_layers is None:
        num_layers = max(1, cfg.num_layers - 2)
    if not 1 <= num_layers <= cfg.num_layers:
        raise ValueError(f"draft layers {num_layers} not in [1, "
                         f"{cfg.num_layers}]")
    return (weights._replace(layers=weights.layers[:num_layers]),
            dataclasses.replace(cfg, num_layers=num_layers))


# the serve's MoE capacity factor: JAX's serve sets 8.0 for MoE
# (apex_tpu/testing/standalone_gpt.py:1333-1337); with E = 8 every expert
# then has a slot for every routed row, so nothing drops
MOE_CAPACITY_FACTOR = 8.0


def moe_serving_weights(weights: GPTServingWeights, num_experts: int,
                        seed: int) -> GPTServingWeights:
    """The serve's MoE model: every layer expanded to ``num_experts``
    bias-free experts (:func:`~apex_tpu_torch.serving.expand_moe_weights`)
    with fp32 ``0.02 * randn`` routers from a generator seeded ``seed``,
    and expert e's ``wi`` scaled by ``1 + 0.05 e`` so that the experts
    differ and a wrong route changes the output."""
    g = torch.Generator(device=weights.wte.device)
    g.manual_seed(int(seed))
    moe = expand_moe_weights(weights, num_experts, g)
    scale = 1.0 + 0.05 * torch.arange(num_experts, dtype=torch.float32,
                                      device=weights.wte.device)
    return moe._replace(layers=tuple(
        lw._replace(wi=(lw.wi.float() * scale[:, None, None]).to(lw.wi.dtype))
        for lw in moe.layers))


def serve_smoke(num_requests: int = 8, *, model: str = "gpt345m",
                policy: str = "O5", max_new_tokens: int = 32,
                prompt_lengths: Optional[Sequence[int]] = None,
                min_prompt: int = 64, max_prompt: int = 700,
                seed: int = 0, device=None, speculate_k: int = 0,
                draft: str = "self", draft_layers: Optional[int] = None,
                prefill_chunk: int = 0, prefix_share: bool = False,
                spec_governor="auto", kv_dtype: str = "model",
                moe_experts: int = 0,
                moe_capacity_factor: float = MOE_CAPACITY_FACTOR):
    """Build the model and engine on ``device`` (cuda unless the CPU is
    asked for), serve ``num_requests`` seeded prompts, and return
    ``(summary, engine)``; ``engine.done`` holds every request with its
    ``prompt`` and ``out_tokens``.

    ``policy`` "Q8" quantizes every layer matmul weight of the
    policy-cast (bf16) model to per-column int8 (:func:`quantize_weights`),
    as the JAX smoke does; ``kv_dtype`` ("model", "bf16", "int8") is the
    cache's storage (the JAX flag ``APEX_TPU_SERVE_KV_DTYPE``).
    ``moe_experts=E`` serves the MoE model of :func:`moe_serving_weights`
    (router seed ``seed + 2``) at ``moe_capacity_factor``; it does not
    compose with Q8, as in JAX.

    Prompt lengths are drawn from ``seed`` in ``[min_prompt,
    max_prompt]`` (clipped so prompt + ``max_new_tokens`` fits the
    ladder span and ``max_seq``), unless ``prompt_lengths`` names
    them.

    The fast path: ``speculate_k=K`` proposes K tokens a tick from a
    draft — ``draft="self"`` is the target itself (acceptance exactly
    1.0, the machinery's ceiling), ``"truncated"`` the target's first
    ``draft_layers`` layers (:func:`truncated_draft`: rejections and
    rollbacks); ``spec_governor`` as :class:`ServingEngine` takes it.
    ``prefill_chunk=N`` admits prompts in N-token chunks;
    ``prefix_share`` maps warm prompt prefixes as shared pages.  Every
    option leaves the greedy tokens unchanged."""
    dev = resolve_device(device)
    cfg = model_config(model, policy=policy)
    cache_cfg = default_cache_config(cfg, kv_dtype=kv_dtype)
    ladder = BucketLadder()
    weights = init_serving_weights(cfg, seed=seed, device=dev)
    if get_policy(policy).quantize_weights == "int8":
        if moe_experts:
            raise ValueError("MoE does not compose with the Q8 tier: the "
                             "int8 kernels have no expert-stack layout")
        weights = quantize_weights(weights)
    if moe_experts:
        cfg = dataclasses.replace(cfg, num_experts=moe_experts,
                                  moe_capacity_factor=moe_capacity_factor)
        weights = moe_serving_weights(weights, moe_experts, seed + 2)
    draft_weights = draft_cfg = None
    if speculate_k > 0:
        if draft == "self":
            draft_weights, draft_cfg = weights, cfg
        elif draft == "truncated":
            draft_weights, draft_cfg = truncated_draft(weights, cfg,
                                                       draft_layers)
        else:
            raise ValueError(f"draft {draft!r} not in {DRAFTS}")
    engine = ServingEngine(weights, cfg, cache_cfg, ladder=ladder,
                           device=dev, speculate_k=speculate_k,
                           draft_weights=draft_weights,
                           draft_cfg=draft_cfg,
                           prefill_chunk=prefill_chunk,
                           prefix_share=prefix_share,
                           spec_governor=spec_governor)
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
    ``apex_tpu/testing/standalone_gpt.py:69-102``), then
    ``embedding_dropout`` in a ``deterministic=False`` forward; ``attend``
    is the tied LM head.  Both tables are ``embedding`` parameters, as in
    the flax tree."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_sequence_length: int, *, embedding_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding_dropout = embedding_dropout
        self.word_embeddings = VocabParallelEmbedding(
            vocab_size, hidden_size, dtype=dtype, device=device)
        self.position_embeddings = VocabParallelEmbedding(
            max_sequence_length, hidden_size, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        pos = torch.arange(tokens.shape[-1], device=tokens.device)
        h = self.word_embeddings(tokens) + self.position_embeddings(pos)
        return dropout(h, self.embedding_dropout, dropout_rng(
            deterministic, (self.embedding_dropout,), rng))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return self.word_embeddings.attend(x)


class GPTModel(nn.Module):
    """Embedding -> transformer -> tied head, returning (b, s, vocab)
    logits in the compute ``dtype`` (ref:
    ``apex_tpu/testing/standalone_gpt.py:105-149``).  A forward with
    ``deterministic=False`` and a :class:`DropoutRNG` applies
    ``attention_dropout`` and ``hidden_dropout`` (the embedding's rate
    too), JAX's defaults 0.1 each.  ``ffn_hidden_size`` (None: 4h),
    ``checkpoint_activations`` and ``checkpoint_policy`` are the
    transformer's (JAX's ``:115-136``).  Parameters are fp32 until
    :func:`apex_tpu_torch.amp.initialize` casts them; ``kernels=False``
    runs every kernel's plain version (the oracle configuration)."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 num_attention_heads: int, max_sequence_length: int, *,
                 ffn_hidden_size: Optional[int] = None,
                 attention_dropout: float = 0.1, hidden_dropout: float = 0.1,
                 use_flash: bool = True,
                 checkpoint_activations: bool = False,
                 checkpoint_policy: str = "full", kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.embedding = GPTEmbedding(vocab_size, hidden_size,
                                      max_sequence_length,
                                      embedding_dropout=hidden_dropout,
                                      dtype=dtype, device=device)
        self.transformer = ParallelTransformer(
            num_layers, hidden_size, num_attention_heads,
            ffn_hidden_size=ffn_hidden_size,
            attention_dropout=attention_dropout,
            hidden_dropout=hidden_dropout, use_flash=use_flash,
            checkpoint_activations=checkpoint_activations,
            checkpoint_policy=checkpoint_policy,
            kernels=kernels, dtype=dtype, device=device)

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

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        h = self.embedding(tokens, deterministic, rng)
        return self.embedding.attend(self.transformer(
            h, deterministic=deterministic, rng=rng))


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
    seeded batch, the step's size, and the dropout's random state (None
    without dropout)."""

    model: GPTModel
    amp_opt: Any
    tokens: torch.Tensor
    labels: torch.Tensor
    n_params: int
    flops_per_step: float
    rng: Optional[DropoutRNG] = None

    @property
    def tokens_per_step(self) -> int:
        return self.tokens.numel()


def make_train_setup(model: str = "gpt345m", *, policy: str = "O5",
                     seed: int = 0, kernels: bool = True,
                     attention_dropout: float = 0.0,
                     hidden_dropout: float = 0.0,
                     device=None) -> TrainSetup:
    """Build the preset's GPT from seeded weights on ``device`` (cuda
    unless the CPU is asked for) in the ``policy``'s train recipe
    (:data:`TRAIN_RECIPES`), ``amp.initialize`` it with
    ``fused_adam(TRAIN_LR)`` at that policy, and draw one batch (labels =
    tokens shifted by one) from the same ``seed``.  ``kernels=False``
    runs every kernel's plain version, on the same weights and data.
    With a dropout rate > 0 the setup owns the step's
    :class:`DropoutRNG`, seeded ``seed + 1``: a kernel and a plain run
    from one seed draw the same dropout seeds."""
    if policy not in TRAIN_RECIPES:
        raise ValueError(f"the train recipes are {sorted(TRAIN_RECIPES)}, "
                         f"not {policy!r}")
    dev = resolve_device(device)
    geo = MODELS[model]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    net = GPTModel(geo["vocab_size"], geo["hidden_size"], geo["num_layers"],
                   geo["num_heads"], geo["max_seq"],
                   attention_dropout=attention_dropout,
                   hidden_dropout=hidden_dropout, kernels=kernels,
                   dtype=get_policy(policy).param_dtype, device=dev,
                   **TRAIN_RECIPES[policy]).reset_parameters(g)
    b, s = geo["batch"], geo["seq"]
    tokens = torch.randint(0, geo["vocab_size"], (b, s), generator=g,
                           device=dev)
    n_params = sum(p.numel() for p in net.parameters())
    opt = fused_adam(TRAIN_LR, kernels=kernels)
    # the persistent pipeline at every preset where the policy has master
    # weights, as the recipes were built and measured (the default route
    # would send the tiny CPU preset to the staged route: under 128 MiB);
    # the staged route on the parameters themselves where it has none
    # (JAX's make_train_setup passes pipeline=True only then)
    masters = bool(get_policy(policy).master_weights)
    net, amp_opt = amp.initialize(net, opt, opt_level=policy,
                                  pipeline=True if masters else None)
    rng = DropoutRNG(seed + 1, dev) \
        if attention_dropout > 0.0 or hidden_dropout > 0.0 else None
    return TrainSetup(net, amp_opt, tokens, torch.roll(tokens, -1, dims=-1),
                      n_params, model_flops(model, n_params), rng)


def model_flops(model: str, n_params: int) -> float:
    """bench.py's model FLOPs of one train step of the preset
    (``bench.py:2251-2252``): 6 N per token, N the parameter count (the
    position table's ``max_seq`` rows included), plus the attention
    scores, 12 L hidden s^2 a batch row (dropout adds none)."""
    geo = MODELS[model]
    b, s = geo["batch"], geo["seq"]
    return 6.0 * n_params * b * s \
        + 12.0 * geo["num_layers"] * geo["hidden_size"] * s * s * b


def _forward_loss(model, tokens, labels, rng):
    return gpt_loss(model(tokens, deterministic=rng is None, rng=rng),
                    labels)


def forward_backward(setup: TrainSetup) -> torch.Tensor:
    """Zero the grads, run the forward (with dropout, fresh seeds and
    masks from the setup's RNG) and the loss, under ``amp.autocast`` for
    a policy that casts ops (O1, O4), and the scaled loss's backward.
    Returns the (unscaled) loss, still on the device."""
    setup.amp_opt.zero_grad()
    loss = amp.autocast(_forward_loss, policy=setup.amp_opt.policy)(
        setup.model, setup.tokens, setup.labels, setup.rng)
    setup.amp_opt.scale_loss(loss).backward()
    return loss.detach()


def train_step(setup: TrainSetup):
    """One step: :func:`forward_backward`, then the fused optimizer step.
    Returns the (unscaled) loss, still on the device, and the step's
    ``StepInfo``."""
    loss = forward_backward(setup)
    return loss, setup.amp_opt.apply_gradients()


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
    order (the pipeline), or of the stepped tensors in parameter order
    (the staged route: the masters, or the parameters themselves)."""
    h = hashlib.sha256()
    bufs = [g.master for g in amp_opt.groups] if amp_opt.use_pipeline \
        else amp_opt._masters
    for b in bufs:
        h.update(b.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def train_smoke(steps: int = 8, *, model: str = "gpt345m",
                policy: str = "O5", seed: int = 0, kernels: bool = True,
                attention_dropout: float = 0.0, hidden_dropout: float = 0.0,
                device=None) -> TrainResult:
    """:func:`make_train_setup`, then ``steps`` :func:`train_step` s on
    its one batch, each timed through the read of its loss."""
    setup = make_train_setup(model, policy=policy, seed=seed,
                             kernels=kernels,
                             attention_dropout=attention_dropout,
                             hidden_dropout=hidden_dropout, device=device)
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
                   help="amp opt level; serve: O5 (bf16), O0 (fp32) or Q8 "
                        "(bf16, int8 weight-only layer matmuls); train: O5 "
                        "(bf16, flash), O2 (fp16, fused softmax, dynamic "
                        "loss scale), O4 / O1 (fp32 model, bf16 / fp16 "
                        "autocast, flash; O1 a dynamic loss scale), O0 "
                        "(fp32) or O3 (fp16, no masters), both fused "
                        "softmax")
    p.add_argument("--kv-dtype", choices=KV_DTYPES, default="model",
                   help="serve: the KV cache's storage: the model's dtype, "
                        "bf16, or int8 with one fp32 scale per cached row")
    p.add_argument("--steps", type=int, default=8,
                   help="train: optimizer steps")
    p.add_argument("--attention-dropout", type=float, default=0.0,
                   metavar="RATE",
                   help="train: attention dropout (in the E flash kernels "
                        "at O5); 0.1 alone is bench.py's gpt2_345m_dropout")
    p.add_argument("--hidden-dropout", type=float, default=0.0,
                   metavar="RATE",
                   help="train: hidden dropout after attention and the MLP, "
                        "and the embedding's")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--min-prompt", type=int, default=64)
    p.add_argument("--max-prompt", type=int, default=700)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--speculate-k", type=int, default=0, metavar="K",
                   help="serve: speculative decoding, a draft proposes K "
                        "tokens a tick and the target verifies them in "
                        "one multi-token step (the tokens stay those of "
                        "plain greedy decode)")
    p.add_argument("--draft", choices=DRAFTS, default="self",
                   help="serve --speculate-k: 'self' is the target "
                        "itself (acceptance 1.0), 'truncated' its first "
                        "--draft-layers layers")
    p.add_argument("--draft-layers", type=int, default=None, metavar="N",
                   help="serve --draft truncated: the draft's depth "
                        "(default: all but the target's last two layers)")
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="N",
                   help="serve: admit prompts in N-token chunks, one a "
                        "tick beside decode")
    p.add_argument("--prefix-share", action="store_true",
                   help="serve: copy-on-write prompt-prefix sharing")
    p.add_argument("--moe-experts", type=int, default=0, metavar="E",
                   help="serve: every layer's MLP a Switch top-1 mixture of "
                        "E experts (row 18's routing kernel)")
    p.add_argument("--moe-capacity-factor", type=float,
                   default=MOE_CAPACITY_FACTOR, metavar="CF",
                   help="serve --moe-experts: expert capacity "
                        "max(1, int(CF * rows / E)) a routed step")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.train:
        if args.policy not in TRAIN_RECIPES:
            parser.error(f"--train runs at {sorted(TRAIN_RECIPES)}, not "
                         f"{args.policy}")
        r = train_smoke(args.steps, model=args.model, policy=args.policy,
                        seed=args.seed,
                        attention_dropout=args.attention_dropout,
                        hidden_dropout=args.hidden_dropout,
                        device=args.device)
        _, scale, skipped, _ = r.steps[-1]
        print(f"TRAIN_DONE policy={args.policy} steps={len(r.losses)} "
              f"attention_dropout={args.attention_dropout:g} "
              f"hidden_dropout={args.hidden_dropout:g} "
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
        max_prompt=args.max_prompt, seed=args.seed, device=args.device,
        speculate_k=args.speculate_k, draft=args.draft,
        draft_layers=args.draft_layers, prefill_chunk=args.prefill_chunk,
        prefix_share=args.prefix_share, kv_dtype=args.kv_dtype,
        moe_experts=args.moe_experts,
        moe_capacity_factor=args.moe_capacity_factor)
    fast = ""
    if s.spec_accept_rate is not None:
        fast += (f" spec_accept_rate={s.spec_accept_rate} "
                 f"spec_proposed={s.spec_tokens_proposed}"
                 + (" spec_disabled=1" if s.spec_disabled else ""))
    if s.warm_prefix_admissions or s.shared_blocks_hw:
        fast += (f" warm_admissions={s.warm_prefix_admissions} "
                 f"prefix_hit_tokens={s.prefix_hit_tokens} "
                 f"shared_blocks_hw={s.shared_blocks_hw} "
                 f"cow_copies={s.cow_copies}")
    if s.prefill_chunks:
        fast += f" prefill_chunks={s.prefill_chunks}"
    if args.moe_experts:
        fast += (f" moe_experts={args.moe_experts} "
                 f"moe_capacity_factor={args.moe_capacity_factor}")
    print(f"SERVE_DONE policy={args.policy} kv_dtype={args.kv_dtype} "
          f"requests={s.requests_done} "
          f"tokens={s.tokens_generated} tokens_s={s.tokens_per_sec} "
          f"p50_ms={s.latency_p50_ms} p99_ms={s.latency_p99_ms} "
          f"ttft_p50_ms={s.ttft_p50_ms} ttft_p99_ms={s.ttft_p99_ms} "
          f"itl_p50_ms={s.itl_p50_ms} itl_p99_ms={s.itl_p99_ms} "
          f"steps={s.decode_steps}{fast} device={s.device} "
          f"digest={eng.tokens_digest()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
