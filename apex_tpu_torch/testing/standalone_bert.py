"""Standalone BERT: the port's BERT model and its train entry point.

Counterpart of ``apex_tpu/testing/standalone_bert.py``: the model
(``bert_extended_attention_mask``, ``BertEmbedding``, ``Pooler``,
``BertLMHead``, ``BertModel``), the weight carry-across from the JAX
model's parameters (:func:`bert_params_from_numpy`), and the train
loop with its CLI::

    python -m apex_tpu_torch.testing.standalone_bert --train
    python -m apex_tpu_torch.testing.standalone_bert --train --policy O2
    python -m apex_tpu_torch.testing.standalone_bert --train --full-mask
    python -m apex_tpu_torch.testing.standalone_bert --train \
        --attention-dropout 0.1 --hidden-dropout 0.1
    python -m apex_tpu_torch.testing.standalone_bert --train --model tiny \
        --device cpu --steps 4

The default model is BERT-large's width (vocab 30528, hidden 1024, 24
layers, 16 heads, ffn 4096) at seq 512, batch 16, with seeded random
weights: no checkpoint is read.  ``--train`` takes ``--steps`` optimizer
steps on one seeded batch whose rows are padded (each row's valid length
drawn from the seed in [seq / 4, seq], the first quarter of the rows
full; ``--full-mask``: every row full, ``bench_bert_large``'s all-ones
mask, ``bench.py:2337``), in one of the JAX package's two BERT recipes
(:data:`TRAIN_RECIPES`), and prints one ``TRAIN_DONE`` line:

* ``O5`` is ``bench.py``'s ``bench_bert_large`` (:2315-2364): bf16,
  ``use_flash=True`` (the (b, s) mask rides the E flash kernels' kv_mask
  lane), ``fused_lamb(1e-3)``, a static scale of 1;
* ``O2`` is ``make_smoke_setup``'s route (:206-233) in fp16:
  ``use_flash=False`` (the extended (b, 1, s, s) mask through
  ``FusedScaleMaskSoftmax``'s padding branch, the padding-mask softmax
  kernel), ``fused_adam(1e-3)``, fp32 masters, a dynamic loss scale.

Both recipes run without dropout, as the JAX ones do, unless
``--attention-dropout`` / ``--hidden-dropout`` set rates (the
embedding's is the hidden rate): at O5 the padded batch then takes the
E kernels' kv_mask + dropout lane.

The loss is the JAX step's: the mean of the per-token LM cross-entropy
over every position (labels = tokens rolled by one) plus the mean NSP
cross-entropy of the binary head, both through the fused xentropy in
fp32.  Both run on the card unless ``--device cpu`` is asked for.

The step's model FLOPs are ``bench.py``'s ``6·N·tokens + 12·L·h·s²·b``
with the attention term over the live (query, key) pairs, those whose
query and key are both real (:func:`bert_model_flops`): on the all-ones
mask that is bench.py's figure.  ``tokens_s`` counts every position, as
bench.py does; ``real_tokens_s`` counts the real ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import amp, resolve_device
from ..amp import get_policy
from ..contrib.xentropy import softmax_cross_entropy_loss
from ..normalization import FusedLayerNorm
from ..optimizers import fused_adam, fused_lamb
from ..transformer import DropoutRNG, ParallelTransformer
from ..transformer.enums import AttnMaskType
from ..transformer.tensor_parallel import (ColumnParallelLinear,
                                           VocabParallelEmbedding)
from .standalone_gpt import (GPTEmbedding, TrainResult,
                             gpt_params_from_numpy, masters_digest)

__all__ = ["MODELS", "TRAIN_RECIPES", "bert_extended_attention_mask",
           "BertEmbedding", "Pooler", "BertLMHead",
           "BertModel", "bert_params_from_numpy", "padded_mask",
           "bert_model_flops",
           "BertTrainSetup", "make_train_setup", "bert_loss", "train_step",
           "train_smoke", "bert_model_provider", "main"]

# model presets: the geometry and the training batch (``seq`` tokens by
# ``batch`` rows)
MODELS = {
    # BERT-large, the width and the batch bench.py's bench_bert_large runs
    "bertlarge": dict(vocab_size=30528, hidden_size=1024, num_heads=16,
                      num_layers=24, seq=512, batch=16),
    # the CPU smoke size
    "tiny": dict(vocab_size=256, hidden_size=128, num_heads=2,
                 num_layers=2, seq=64, batch=4),
}
# the train recipes, by amp policy; the compute dtype is the policy's
# model dtype
TRAIN_RECIPES = {"O5": dict(use_flash=True, optimizer="lamb"),
                 "O2": dict(use_flash=False, optimizer="adam")}
TRAIN_LR = 1e-3


def bert_extended_attention_mask(attention_mask: torch.Tensor
                                 ) -> torch.Tensor:
    """(b, s) 1 = real / 0 = pad -> (b, 1, s, s) boolean, True = masked
    out (ref: ``apex_tpu/testing/standalone_bert.py:28-34``: the outer
    product, then ``< 0.5``): a pair is kept only when both its query
    and its key are real, so every padded query row is masked whole."""
    m = attention_mask.float()
    return (m[:, None, :] * m[:, :, None])[:, None] < 0.5


class BertEmbedding(GPTEmbedding):
    """The GPT embedding plus token-type embeddings (ref:
    ``standalone_bert.py:45-65``).  Flax creates the token-type table
    only when the model is initialized with ``tokentype_ids``; the JAX
    train recipes pass none, so their trees have no table, and the port's
    recipes build the model with ``num_tokentypes=0`` to match."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_sequence_length: int, *, num_tokentypes: int = 2,
                 embedding_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(vocab_size, hidden_size, max_sequence_length,
                         embedding_dropout=embedding_dropout, dtype=dtype,
                         device=device)
        self.num_tokentypes = num_tokentypes
        if num_tokentypes > 0:
            self.tokentype_embeddings = VocabParallelEmbedding(
                num_tokentypes, hidden_size, dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor,
                tokentype_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        h = super().forward(tokens, deterministic, rng)
        if tokentype_ids is not None and self.num_tokentypes > 0:
            h = h + self.tokentype_embeddings(tokentype_ids)
        return h


class Pooler(nn.Module):
    """The [CLS] pooler: dense and tanh over position 0 (ref:
    ``standalone_bert.py:68-79``)."""

    def __init__(self, hidden_size: int, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dense = ColumnParallelLinear(hidden_size, hidden_size,
                                          dtype=dtype, device=device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertLMHead(nn.Module):
    """The masked-LM head (ref: ``standalone_bert.py:82-101``): dense,
    tanh GELU and LayerNorm in the compute dtype, then the tied
    embedding's logits plus a per-vocab ``bias`` created fp32, as flax
    declares it (the amp cast then takes it to the model dtype, as it
    does in JAX)."""

    def __init__(self, hidden_size: int, vocab_size: int, *,
                 layernorm_epsilon: float = 1e-5, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = ColumnParallelLinear(hidden_size, hidden_size,
                                          dtype=dtype, device=device)
        self.layernorm = FusedLayerNorm(hidden_size, eps=layernorm_epsilon,
                                        kernels=kernels, device=device)
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, hidden: torch.Tensor, attend) -> torch.Tensor:
        x = F.gelu(self.dense(hidden), approximate="tanh")
        x = self.layernorm(x).to(self.dtype)
        return attend(x) + self.bias


class BertModel(nn.Module):
    """Embedding -> padding-mask transformer -> LM head, and the NSP
    binary head over the pooled [CLS] state (ref:
    ``standalone_bert.py:104-177``); a forward with
    ``deterministic=False`` and a :class:`DropoutRNG` applies
    ``attention_dropout`` and ``hidden_dropout`` (the embedding's rate
    too), JAX's defaults 0.1 each.  ``use_flash``
    routes the (b, s) mask through the E flash kernels' kv_mask lane;
    without it the extended (b, 1, s, s) mask goes through the
    padding-mask softmax.  The mask is put into that one device format
    once a forward, here, and handed to every layer.  The binary head
    computes in fp32 on its (model-dtype) weights, as flax's
    ``nn.Dense(dtype=float32)`` promotes them.
    ``checkpoint_activations`` checkpoints every transformer layer
    (JAX's ``:114``, ``:135``; the recompute replays the dropout).
    Parameters are fp32 until :func:`apex_tpu_torch.amp.initialize`
    casts them; ``kernels=False`` runs every kernel's plain version (the
    oracle configuration)."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 num_attention_heads: int, max_sequence_length: int, *,
                 num_tokentypes: int = 2, attention_dropout: float = 0.1,
                 hidden_dropout: float = 0.1,
                 checkpoint_activations: bool = False,
                 use_flash: bool = False, kernels: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.use_flash = use_flash
        self.embedding = BertEmbedding(
            vocab_size, hidden_size, max_sequence_length,
            num_tokentypes=num_tokentypes, embedding_dropout=hidden_dropout,
            dtype=dtype, device=device)
        self.transformer = ParallelTransformer(
            num_layers, hidden_size, num_attention_heads,
            attn_mask_type=AttnMaskType.padding,
            attention_dropout=attention_dropout,
            hidden_dropout=hidden_dropout, use_flash=use_flash,
            checkpoint_activations=checkpoint_activations,
            kernels=kernels, dtype=dtype, device=device)
        self.lm_head = BertLMHead(hidden_size, vocab_size, kernels=kernels,
                                  dtype=dtype, device=device)
        self.pooler = Pooler(hidden_size, dtype=dtype, device=device)
        self.binary_head = ColumnParallelLinear(hidden_size, 2,
                                                dtype=torch.float32,
                                                device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> "BertModel":
        """Seeded random weights from ``generator``, drawn in module
        order: embeddings normal(0, 0.02), kernels normal with variance
        1/fan_in, biases zero, LayerNorm ones/zeros."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def forward(self, tokens: torch.Tensor, attention_mask: torch.Tensor,
                tokentype_ids: Optional[torch.Tensor] = None,
                lm_labels: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                rng: Optional[DropoutRNG] = None):
        """``(lm_logits, binary_logits)``, or with ``lm_labels`` the fp32
        per-token LM loss (b, s) in place of the logits."""
        h = self.embedding(tokens, tokentype_ids, deterministic, rng)
        if self.use_flash:
            kv_mask = attention_mask.to(torch.float32).contiguous()
            h = self.transformer(h, None, kv_mask, deterministic, rng)
        else:
            h = self.transformer(h, bert_extended_attention_mask(
                attention_mask), None, deterministic, rng)
        binary_logits = self.binary_head(self.pooler(h).float())
        lm_logits = self.lm_head(h, self.embedding.attend)
        if lm_labels is None:
            return lm_logits, binary_logits
        return (softmax_cross_entropy_loss(lm_logits, lm_labels, 0.0, True),
                binary_logits)


def bert_model_provider(args, pre_process: bool = True,
                        post_process: bool = True, **overrides
                        ) -> BertModel:
    """A :class:`BertModel` from Megatron's arguments (ref:
    ``apex_tpu/testing/standalone_bert.py:400-416``, itself
    ``standalone_bert.py:215-223``): the geometry, the dropout rates,
    ``checkpoint_activations`` and ``params_dtype`` (the compute dtype)
    from ``args`` (:func:`~apex_tpu_torch.testing.arguments.parse_args`);
    ``overrides`` replace any of them or add the others (``use_flash``,
    left at the model's default False: the materialized scores through
    the padding-mask softmax; ``num_tokentypes``, ``kernels``,
    ``device``).  The weights are drawn by ``reset_parameters`` from a
    generator on the model's device seeded with ``args.seed``.  One
    program holds the whole model, so ``pre_process`` and
    ``post_process`` change nothing."""
    del pre_process, post_process
    kw = dict(vocab_size=args.vocab_size, hidden_size=args.hidden_size,
              num_layers=args.num_layers,
              num_attention_heads=args.num_attention_heads,
              max_sequence_length=args.max_position_embeddings,
              attention_dropout=args.attention_dropout,
              hidden_dropout=args.hidden_dropout,
              checkpoint_activations=getattr(args, "checkpoint_activations",
                                             False),
              dtype=args.params_dtype)
    kw.update(overrides)
    dev = resolve_device(kw.pop("device", None))
    net = BertModel(device=dev, **kw)
    g = torch.Generator(device=dev)
    g.manual_seed(int(args.seed))
    return net.reset_parameters(g)


def bert_params_from_numpy(flax_params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """A state dict for :class:`BertModel` from the JAX ``BertModel``'s
    parameter tree as numpy (``jax.tree.map(np.asarray, params)``), by
    the GPT mapper's conventions: the nested names joined by dots are the
    port's parameter names (``lm_head.bias``,
    ``transformer.layer_0.self_attention.query_key_value.kernel``,
    ``binary_head.kernel``, ...) and the layouts are the same."""
    return gpt_params_from_numpy(flax_params)


def padded_mask(batch: int, seq: int, generator: torch.Generator,
                device=None) -> torch.Tensor:
    """A (batch, seq) int64 padding mask, 1 = real: the first
    ``max(1, batch // 4)`` rows full, every other row's valid length drawn
    from ``generator`` uniformly in [seq / 4, seq] (BERT pads each
    sequence's tail)."""
    full = max(1, batch // 4)
    lens = torch.randint(max(1, seq // 4), seq + 1, (batch,),
                         generator=generator, device=device)
    lens[:full] = seq
    return (torch.arange(seq, device=device)[None, :]
            < lens[:, None]).long()


def bert_model_flops(n_params: int, num_layers: int, hidden_size: int,
                     mask: torch.Tensor) -> float:
    """A step's model FLOPs over a (b, s) 1 = real mask: ``6·N`` a
    position (the dense layers run over the padding too) plus
    ``12·L·h`` a live (query, key) pair, both real; on an all-ones mask
    ``6·N·b·s + 12·L·h·s²·b``, ``bench.py:2394-2395``."""
    lens = mask.sum(-1).double()
    pairs = float((lens * lens).sum())
    return 6.0 * n_params * mask.numel() \
        + 12.0 * num_layers * hidden_size * pairs


@dataclasses.dataclass
class BertTrainSetup:
    """A BERT ready to train: the cast module, its amp optimizer, one
    seeded batch (padded, or all real), and the step's size."""

    model: BertModel
    amp_opt: Any
    tokens: torch.Tensor
    mask: torch.Tensor
    labels: torch.Tensor
    nsp: torch.Tensor
    n_params: int
    flops_per_step: float
    real_tokens: int
    rng: Optional[DropoutRNG] = None

    @property
    def tokens_per_step(self) -> int:
        return self.tokens.numel()


def make_train_setup(model: str = "bertlarge", *, policy: str = "O5",
                     seed: int = 0, kernels: bool = True,
                     full_mask: bool = False, attention_dropout: float = 0.0,
                     hidden_dropout: float = 0.0,
                     device=None) -> BertTrainSetup:
    """Build the preset's BERT from seeded weights on ``device`` (cuda
    unless the CPU is asked for) in the ``policy``'s recipe
    (:data:`TRAIN_RECIPES`), ``amp.initialize`` it with
    ``fused_lamb(TRAIN_LR)`` (O5) or ``fused_adam(TRAIN_LR)`` (O2), and
    draw one batch from the same ``seed``: tokens, the mask
    (:func:`padded_mask`; all ones with ``full_mask``, as bench.py's),
    labels = tokens rolled by one, NSP labels in {0, 1}.
    ``kernels=False`` runs every kernel's plain version, on the same
    weights and data.  With a dropout rate > 0 the setup owns the step's
    :class:`DropoutRNG`, seeded ``seed + 1``, as the GPT recipe's."""
    if policy not in TRAIN_RECIPES:
        raise ValueError(f"the BERT train recipes are "
                         f"{sorted(TRAIN_RECIPES)}, not {policy!r}")
    recipe = TRAIN_RECIPES[policy]
    dev = resolve_device(device)
    geo = MODELS[model]
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    b, s = geo["batch"], geo["seq"]
    net = BertModel(geo["vocab_size"], geo["hidden_size"],
                    geo["num_layers"], geo["num_heads"], s,
                    num_tokentypes=0, attention_dropout=attention_dropout,
                    hidden_dropout=hidden_dropout,
                    use_flash=recipe["use_flash"],
                    kernels=kernels, dtype=get_policy(policy).param_dtype,
                    device=dev).reset_parameters(g)
    tokens = torch.randint(0, geo["vocab_size"], (b, s), generator=g,
                           device=dev)
    mask = padded_mask(b, s, g, device=dev)
    if full_mask:
        mask = torch.ones_like(mask)
    nsp = torch.randint(0, 2, (b,), generator=g, device=dev)
    n_params = sum(p.numel() for p in net.parameters())
    opt = (fused_lamb if recipe["optimizer"] == "lamb" else fused_adam)(
        TRAIN_LR, kernels=kernels)
    # JAX's routing: BERT-large (672 MB cast) packs into the persistent
    # pipeline, the tiny preset takes the staged route
    net, amp_opt = amp.initialize(net, opt, opt_level=policy)
    flops = bert_model_flops(n_params, geo["num_layers"],
                             geo["hidden_size"], mask)
    rng = DropoutRNG(seed + 1, dev) \
        if attention_dropout > 0.0 or hidden_dropout > 0.0 else None
    return BertTrainSetup(net, amp_opt, tokens, mask,
                          torch.roll(tokens, -1, dims=-1), nsp, n_params,
                          flops, int(mask.sum()), rng)


def bert_loss(model: BertModel, tokens, mask, labels, nsp,
              rng: Optional[DropoutRNG] = None) -> torch.Tensor:
    """The JAX step's loss: mean LM cross-entropy plus mean NSP
    cross-entropy, fp32; with ``rng``, through a dropout forward."""
    lm_loss, bin_logits = model(tokens, mask, lm_labels=labels,
                                deterministic=rng is None, rng=rng)
    nsp_loss = softmax_cross_entropy_loss(bin_logits, nsp, 0.0,
                                          True).mean()
    return lm_loss.mean() + nsp_loss


def train_step(setup: BertTrainSetup):
    """One step: zero the flat grads, forward, the scaled loss's
    backward, and the fused optimizer sweeps.  Returns the (unscaled)
    loss, still on the device, and the step's ``StepInfo``."""
    setup.amp_opt.zero_grad()
    loss = bert_loss(setup.model, setup.tokens, setup.mask, setup.labels,
                     setup.nsp, setup.rng)
    setup.amp_opt.scale_loss(loss).backward()
    info = setup.amp_opt.apply_gradients()
    return loss.detach(), info


def train_smoke(steps: int = 8, *, model: str = "bertlarge",
                policy: str = "O5", seed: int = 0, kernels: bool = True,
                full_mask: bool = False, attention_dropout: float = 0.0,
                hidden_dropout: float = 0.0, device=None) -> TrainResult:
    """:func:`make_train_setup`, then ``steps`` :func:`train_step` s on
    its one batch, each timed through the read of its loss."""
    setup = make_train_setup(model, policy=policy, seed=seed,
                             kernels=kernels, full_mask=full_mask,
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
        prog="python -m apex_tpu_torch.testing.standalone_bert",
        description="Train the port's BERT for a few steps on one seeded, "
                    "padded batch.")
    p.add_argument("--train", action="store_true", required=True,
                   help="run the mixed-precision train smoke")
    p.add_argument("--model", default="bertlarge", choices=sorted(MODELS))
    p.add_argument("--policy", default="O5", choices=sorted(TRAIN_RECIPES),
                   help="O5: bf16, the flash kv_mask route, fused LAMB; "
                        "O2: fp16, the padding-mask softmax, fused Adam, "
                        "dynamic loss scale")
    p.add_argument("--full-mask", action="store_true",
                   help="every row real (bench.py's all-ones mask), not "
                        "the seeded padded rows")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--attention-dropout", type=float, default=0.0,
                   metavar="RATE",
                   help="attention dropout (at O5 in the E flash kernels' "
                        "kv_mask + dropout lane)")
    p.add_argument("--hidden-dropout", type=float, default=0.0,
                   metavar="RATE",
                   help="hidden dropout after attention and the MLP, and "
                        "the embedding's")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    r = train_smoke(args.steps, model=args.model, policy=args.policy,
                    seed=args.seed, full_mask=args.full_mask,
                    attention_dropout=args.attention_dropout,
                    hidden_dropout=args.hidden_dropout, device=args.device)
    _, scale, skipped, _ = r.steps[-1]
    real = r.setup.real_tokens
    print(f"TRAIN_DONE model=bert-{args.model} policy={args.policy} "
          f"steps={len(r.losses)} "
          f"attention_dropout={args.attention_dropout:g} "
          f"hidden_dropout={args.hidden_dropout:g} "
          f"loss_first={r.losses[0]:.6f} "
          f"loss_last={r.losses[-1]:.6f} skipped={skipped} scale={scale:g} "
          f"real_tokens={real}/{r.setup.mask.numel()} "
          f"step_ms_p50={r.median_ms:.3f} "
          f"tokens_s={r.tokens_per_sec:.1f} "
          f"real_tokens_s={real / (r.median_ms / 1e3):.1f} "
          f"tflops={r.tflops_per_sec:.3f} params={r.setup.n_params} "
          f"device={r.device} digest={masters_digest(r.setup.amp_opt)}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
