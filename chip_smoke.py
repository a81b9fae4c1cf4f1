"""Chip smoke for the PyTorch/H100 port (``apex_tpu_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root

Phases, in order; any failure exits non-zero without the result line:

1. build         — compile every kernel under ``apex_tpu_torch/csrc``
                   (one ``nvcc`` per source, all at once) and print the
                   card's ``nvidia-smi`` name and power limit; then
                   ``cuobjdump -sass`` of the three flash libraries must
                   show HMMA in every bf16/fp16 forward, dK/dV and dQ
                   instantiation, and no forward may spill (each one's
                   registers, spills and shared memory printed); that of
                   ``quant_matmul`` HMMA in each of rows 16 and 17's 32
                   bf16/fp16 instantiations (registers and spills
                   printed).
2. kernels       — hold each kernel against its plain PyTorch version on
                   the card, with the stated tolerances, and time kernel,
                   plain version, one library call and the card's bound:
                   LayerNorm forward, flash prefill and paged decode at
                   the serving path's shapes; the multi-token paged
                   attention at the fast path's verify (t=3) and chunk
                   (t=32, t=16) shapes; LayerNorm backward (its vector
                   path bit for bit its element path's, with gamma in x's
                   dtype and in fp32, and fp32 gamma's dgamma/dbeta
                   against float64 sums), the
                   E-layout flash forward and backward, and the Adam
                   pipeline sweep at the O5 train step's shapes; the
                   causal scaled softmax forward and backward and the
                   norm/finite sweep at the O2 train step's (the
                   forward's 16-byte path bitwise against its element
                   path, taken through a view one element off 16-byte
                   alignment), and the fp16 builds of LayerNorm and the
                   Adam sweep it runs;
                   the Q8 tier's: the int8 GEMV (M <= 8) and tiled (M >
                   8) weight matmuls at the decode tick's and the
                   prefill's, verify's and chunk's shapes (with JAX's
                   self_check shapes, a byte-load tail and an all-zero
                   column), and the int8-cache branches of both paged
                   attention kernels at their float shapes; row 14 (float
                   and int8) also at the long-context user's decode (b =
                   1 and 2 at 16,384 positions) and at d = 128, each case
                   with a seq_len-0 row and a bitwise repeat; the BERT
                   phases': the padding-mask softmax at (16, 16, 512,
                   512) fp32 and fp16 with its extended mask (fully
                   masked query rows exactly 1/sk) and the softmax
                   backward on its fp32 output (timed as its own
                   entry), the kv_mask lanes of the
                   E flash forward and backward at b=16 s=512 h=16 d=64
                   with one all-pad batch row (o = 0, zero gradients),
                   LAMB phase 1 over BERT-large's 336M-element group;
                   the grad routing (``layer_norm`` and ``flash_attention``
                   on grad-requiring inputs record graphs whose backwards
                   are the row-2 and row-8 kernels); the long-context
                   slice's: the (b, h, s, d) backward (row 8) at (1, 16,
                   1024, 64) causal, at sq != sk full and causal and at
                   d = 128 (sq = sk and sq != sk), its fp16
                   instantiations, row 6's forward at d = 128, the E kernels at
                   d = 128 and past a padded length of 1024 (rows 11 and
                   13, counted under their own names) at the long train
                   step's (4, 2048, 16, 64), and the E kernels' time per
                   (q, k) pair at s = 1024..8192 (8192 tokens each); the
                   MoE slice's: the fused routing and dispatch (row 18)
                   at bench.py's bench_moe_ep shape (T 4096, H 256, E 8,
                   fp32; top1/all, top2/all, top2/random) and at the MoE
                   serve's decode (8 rows) and prefill (1024 rows) in
                   bf16 at capacity factors 8.0 and 1.25, off every grain
                   and at T = 32 and 33 (one launch, then two), integers
                   and buffer exactly equal, and its gradient (the plain
                   version at the saved inputs) once on the card; the
                   ResNet slice's (row 19's SGD step, Adam step and SGD
                   pipeline sweep): the steps over ResNet-50's 161 real
                   leaves (bf16 g and copy on the 55 conv/fc leaves, fp32
                   on the 106 batch norms') and the sweep over one
                   25,557,032-element group, each bitwise against its
                   plain version, with the flag grid (Nesterov,
                   dampening, weight decay after the momentum, first
                   run, keep, no/bf16/fp16 copy) on an odd length and on
                   misaligned views; the dropout slice's (the dropout
                   lanes of rows 10-13, rate 0.1, from a seventh
                   generator): the E forward and backward against their
                   plain versions with the same seed (o and lse one bf16
                   ulp of each element + 1e-5, dqkv likewise) and timed
                   beside SDPA with ``dropout_p`` at GPT's (8, 1024, 16,
                   64) causal, BERT's padded (16, 512, 16, 64) with an
                   all-pad row (the kv_mask + dropout lane), (2, 1024, 8,
                   128), the blocked walk's (4, 2048, 16, 64) and JAX's
                   fallback form (2, 1000, 3, 64); then each kernel's
                   keep mask (forward, dQ and dK/dV passes) read back bit
                   for bit against ``rand_keep`` at (2, 1024, 16, 64) and
                   (2, 2048, 16, 64); the update slice's (row 19's four
                   optax-style bodies, from an eighth generator): Adam
                   (both modes), Adagrad, NovoGrad (with and without grad
                   averaging) and momentum SGD (the flag grid) bitwise
                   against their plain versions at every (g, p) pair of
                   fp32, bf16 and fp16 on an odd length and on misaligned
                   views, then timed at n = 67,108,864 with bf16 g and fp32
                   p beside PyTorch's fused in-place steps.
3. serve O5/O0   — GPT-345M width (vocab 50304, hidden 1024, 24 layers,
                   16 heads, max_seq 1024), O5 bf16 then fp32, seeded
                   random weights: serve 8 seeded prompts of 64..700
                   tokens for 32 new tokens each through
                   ``standalone_gpt.serve_smoke``, launch counts reset
                   just before the O5 serve; every serve kernel must have
                   launched, and every served token must equal the argmax
                   of ``gpt_sequence_logits`` run teacher-forced through
                   the plain versions wherever that oracle's top-2 logit
                   gap exceeds the tie tolerance.
3b. serve_fast   — the serving fast path at the same width, launch counts
                   reset just before each leg and every token held against
                   the oracle: speculative decode with K=2 and a self
                   draft at O5 (the multi-token kernel launches once a
                   layer per verify tick, fewer ticks than the plain
                   serve) and fp32 (a draft token may be rejected only at
                   an oracle near-tie); with a truncated draft and no
                   governor (acceptance strictly between 0 and 1, rows
                   rolled back, every block returned); chunked prefill in
                   32-token chunks with a request arriving every second
                   tick (no whole-prompt prefill, one multi-token launch
                   a layer per chunk, decode beside a prefilling prompt);
                   prefix sharing on a 700-token system prompt (cold,
                   priming and warm passes; warm hits copy on write and
                   leave every shared page's bytes unchanged).
3c. serve_q8     — the quantized tier at the same width, launch counts
                   reset just before each leg and held exactly: Q8
                   weights (every layer matmul int8, per-column scales)
                   with an int8 KV cache, every token held against a
                   teacher-forced plain replay through an int8 cache
                   (and its top-1 agreement with the O5 float oracle
                   printed); Q8 over a bf16 cache against
                   ``gpt_sequence_logits`` on the Q8 weights; chunked
                   prefill on the int8 cache.
3d. serve_moe    — the serve with every layer a Switch top-1 mixture of 8
                   experts (``serve_smoke(moe_experts=8)``: fp32 0.02
                   randn routers, expert e's wi scaled by 1 + 0.05 e;
                   1.76 B parameters); each leg serves once untimed,
                   then with launch counts reset just before and held
                   exactly (row 18 once per layer per step), every block
                   back.  cf 8.0 (nothing drops):
                   every token against the teacher-forced plain oracle
                   under the tie rule.  cf 1.25 (decode drops): a
                   recorded rerun prints the drop share and holds row 18
                   against the plain version on the (x, logits) of every
                   25th prefill and decode call it saw.
4. train O5      — the same width at seq 1024, batch 8 (bench.py's
                   bench_gpt345m), O5, ``fused_adam(1e-4)``, seeded
                   weights: 8 steps through ``standalone_gpt.train_smoke``
                   with launch counts reset just before; every train
                   kernel must have launched as often as the step
                   implies, losses finite, step 8's below step 1's.  This
                   and every other GPT and BERT train phase must take
                   amp's persistent pipeline.
5. train plain   — the first 3 steps again from the same weights and
                   batch through every kernel's plain version (no kernel
                   may launch); each loss within ``TRAIN_LOSS_TOL`` of
                   the kernel run's, on the median over ``TRAIN_SEEDS``
                   of each step's gap (3 kernel and 3 plain steps more
                   from each further seed).
6. train O2      — the same width and batch in the O2 recipe
                   (``use_flash=False``: fp32 scores, the fused causal
                   softmax; fp16 parameters and compute, fp32 masters,
                   a dynamic loss scale from 2^16): 8 steps with launch
                   counts reset just before and held exactly; losses
                   finite and falling; each step's scale, skips and grad
                   norm printed.  Then 3 steps through the plain
                   versions (no launch; the same skips; losses within
                   ``TRAIN_O2_LOSS_TOL``), and the overflow leg: from a
                   scale of 2^40, steps until the first applied one,
                   every skipped step holding masters, moments, fp16
                   parameters and the Adam count bitwise, the scale
                   halving from the 2^24 clip.
6b. train_bert   — BERT-large (vocab 30528, hidden 1024, 24 layers, 16
                   heads, ffn 4096) at seq 512, batch 16 (bench.py's
                   bench_bert_large), O5: bf16, the padded batch's (b, s)
                   mask on the E flash kernels' kv_mask lane,
                   ``fused_lamb(1e-3)`` (its global norm by the norm
                   sweep): 8 steps through ``standalone_bert.train_smoke``
                   with launch counts reset just before and held exactly
                   (the kv_mask lanes counted apart from the unmasked
                   ones); losses finite and falling; 3 plain steps, each
                   step's median gap over ``TRAIN_SEEDS`` (3 kernel and
                   3 plain steps a further seed) within
                   ``TRAIN_BERT_LOSS_TOL`` (one limit a step).  Then 8
                   steps on bench.py's own all-ones mask (every token
                   real): the step time, tokens/s and model TFLOP/s of
                   the bench's batch.
6c. train_bert_o2 — the same model and batch in the O2 recipe: fp16, the
                   extended (b, 1, s, s) mask through the padding-mask
                   softmax, ``fused_adam(1e-3)``, a dynamic scale: 8
                   steps, exact counts, per-step scale/skips/grad norm;
                   3 plain steps within ``TRAIN_BERT_O2_LOSS_TOL`` (one
                   limit a step) and the same skips; then 8 steps on
                   the all-ones mask.
6c'. train_bert_recipe — Megatron's BERT-large recipe: ``parse_args``
                   on ``RECIPE_ARGV`` (Megatron's defaults, dropout 0.1,
                   ``--clip-grad 1.0``, ``--weight-decay 0.01``, plus
                   ``--bf16 --checkpoint-activations``), then
                   ``bert_model_provider`` at full width, seq 512, batch
                   16, the padded batch, O5, ``fused_lamb`` on a warmup
                   and linear-decay schedule (``recipe_lr``).  a: the
                   staged route (the materialized scores, rows 5 and 4)
                   for 8 steps with checkpointing on, then off from the
                   same seed: exact counts (the layers' forwards twice
                   under checkpointing), losses finite and falling, the
                   two runs' losses equal bit for bit, peak memory and
                   the step median of each.  b: the same with
                   ``use_flash`` (rows 10/12's kv_mask + dropout lane).
                   c: the pipeline route (counts, the norm sweep), then
                   each route's kernel/plain loss medians over
                   ``TRAIN_SEEDS`` within ``RECIPE_LOSS_TOL``.  d:
                   ``FusedMixedPrecisionLamb`` on the bf16 model with a
                   dynamic scaler, an inf planted at step 4 (masters, m,
                   v, parameters, count bitwise held, the scale halved).
                   e (a, b, c's pipeline run): every step's rate against
                   the schedule at JAX's count, its clip factor and
                   unscaled norm, at least one step clipped.  f: the
                   checkpoint wrapper without its generator replay,
                   planted in a copy (``RECIPE_CKPT_FAULT``): leg a's pair
                   must stop being bitwise.
6d. long_context — bench.py's bench_long_context: flash attention
                   forward and backward under autograd (loss sum(o**2)),
                   causal, bf16, at (b, h, s, d) = (1, 16, 8192, 64),
                   (1, 16, 16384, 64), (1, 32, 4096, 128), (1, 16, 8192,
                   128) and (1, 16, 16384, 128), launch counts reset just
                   before and held exactly (rows 6 and 8 once a shape);
                   each held against the plain versions on a subset of
                   its heads (the heads are independent; all 16 heads'
                   plain scores at s = 16384 would be 17 GB a tensor);
                   forward and backward device ms, the substep's model
                   TFLOP/s at 7 b h s^2 d, the bound, SDPA's times.
6e. train_long   — GPT-345M at seq 2048, batch 4 (bench.py's
                   gpt2_345m_s2048), O5 as ``train``: 8 steps with launch
                   counts reset just before and held exactly (the E
                   kernels under the blocked names, rows 11 and 13, 24 a
                   step each; the unblocked E counts 0); losses finite
                   and falling; 3 plain steps within
                   ``TRAIN_LONG_LOSS_TOL`` (one limit a step), on the
                   median over ``TRAIN_SEEDS`` as ``train plain``.
6e'. train_dropout — bench.py's gpt2_345m_dropout (bench_gpt345m(dropout=
                   0.1)): GPT-345M at seq 1024, batch 8, O5, attention
                   dropout 0.1 inside the E kernels (a fresh host-drawn
                   seed for every layer every step), no hidden dropout:
                   8 steps with launch counts reset just before and held
                   exactly (the E kernels only under the dropout names,
                   24 a step each), losses finite and falling, the step's
                   ratio to the dropout-free train step; 3 plain steps
                   (the same seeds) within ``TRAIN_DROPOUT_LOSS_TOL``, on
                   the median over ``TRAIN_SEEDS`` as ``train plain``.
                   Then the same recipe at seq 2048, batch 4, 8 steps:
                   the blocked dropout names, exact counts.
6f. train_resnet — bench.py's bench_resnet50 through the port's imagenet
                   script (``examples/imagenet/main_amp``): ResNet-50,
                   batch 256, 224x224, 1000 classes, O5 (bf16 convs,
                   fp32 batch norm), ``fused_sgd(0.1, momentum=0.9,
                   weight_decay=1e-4)``, seeded weights and one seeded
                   batch.  The routed default must be the staged route
                   (51 MB of cast model < 128 MiB): 8 steps, launch
                   counts reset just before and held exactly (the
                   leaf-table step's ``sgd_step`` launches, one a dtype
                   pair and table of leaves, ``staged_launches``: 3 a
                   step at 4 KB tables; nothing else), losses finite and
                   falling; step ms, images/s, model TFLOP/s at
                   bench.py's 3 x 4.1 GFLOP an image, the optimizer's
                   host time and peak memory.  Then, on cuDNN's
                   deterministic algorithms, 3 steps with the kernels, 3
                   through the plain versions (no launch) and 3 with
                   ``pipeline=True`` (2 groups, 2 ``sgd_pipeline`` a
                   step), losses within ``TRAIN_RESNET_LOSS_TOL`` of the
                   kernel run's; one staged and one pipeline optimizer
                   stepped twice on the same captured gradients (masters,
                   momenta and model copies bitwise equal); 3 Adam steps
                   (``adam_step``, counted alike); 4 O2 steps (fp16, a
                   dynamic scale from 2^16: scale and skips printed, the
                   same launches an applied step); and the graft entry's eval
                   forward (batch 8, ``train=False``) against the same
                   weights in fp32 compute.
6g. resnet_faults — each fault of ``RESNET_FAULTS`` (the weight decay's
                   sign flipped; every fourth element frozen) planted in
                   a temporary copy of ``fused_sgd.cu``'s leaf-table
                   step, built there, and
                   the deterministic kernel-against-plain leg of
                   train_resnet run in that copy: every fault must move a
                   loss past ``TRAIN_RESNET_LOSS_TOL``.
6h. zero_adam    — bench.py's bench_zero_adam pair at 355,000,320 fp32
                   parameters (``_synthetic_params(355_000_000)``'s ten
                   leaves, seeded): ``fused_adam(1e-3, kernels=False)``
                   (the plain version, no launch), then
                   ``fused_adam(1e-3).update`` + ``apply_updates`` (10
                   ``adam_update`` launches a step, one a leaf), then
                   ``distributed_fused_adam(1e-3)`` over a one-rank NCCL
                   group the script makes and destroys (1 a step, one
                   packed group), 8 steps each with launch counts reset
                   just before and held exactly; each kernel side's
                   parameters and moments bitwise equal to the plain
                   side's after the steps; device and wall ms a step,
                   ``sharded_vs_dense_device``, peak memory, the bound.
6i. optim_update — ``update`` of fused_adam, fused_sgd (momentum 0.9),
                   fused_adagrad and fused_novograd on bench.py's
                   small_leaves_26m_packed tree (398 leaves, 26,000,384
                   elements) with every leaf packed: 8 steps each, 2
                   launches a step (two 2^24-element chunks) held exactly;
                   parameters and state bitwise equal to ``kernels=False``.
6j. ring_flash   — bench.py's bench_ring_flash substep: at (b, h, s_local,
                   d) = (1, 16, 8192, 64) bf16, ``flash_attention_partial``
                   at q_offset 8192, k_offset 0 (every key visible), the
                   logaddexp merge onto o = 0, lse = -1e30, loss sum(o2**2)
                   (the lse reached through the merge), dq, dk, dv by
                   autograd; then the same substep at attention dropout 0.1
                   with head_offset 16.  Launch counts reset just before
                   and held exactly (the partial's four kernels once each);
                   o, lse and the gradients held against the plain versions
                   under the merge's cotangents; times beside SDPA and the
                   substep's TFLOP/s at 14 b h s^2 d.  At s = 1024: the
                   diagonal block, a wholly future block (o = 0, lse JAX's
                   -1e30 * scale bitwise, zero gradients, its merge leaving
                   the live partial bitwise) and the diagonal at dropout,
                   under sum(o**2) + sum(sin(lse)); the dropout kernels'
                   keep masks read back bit-equal to ``rand_keep_global``.
6k. flash_qkv    — ``flash_attention_qkv`` (rows 7 and 9) at GPT-345M's
                   (8, 16, 1024, 64) causal and BERT-large's (16, 16, 512,
                   64) with its padding mask and an all-pad row: counts
                   held exactly, o and dqkv bitwise equal to
                   ``flash_attention`` on qkv's views, held against the
                   plain versions, timed beside SDPA.
6l. multihead_attn — ``contrib.multihead_attn`` at embed 1024, 16 heads,
                   bf16, forward and backward: ``SelfMultiheadAttn`` at
                   (16, 512) with BERT's padding mask (rows 10/12's kv_mask
                   lanes) and the causal time mask, ``EncdecMultiheadAttn``
                   at (16, 256, 512) with a padding mask (rows 6/8's kv_mask
                   lane) and include_norm_add; counts held exactly; each
                   step's output and gradients against an fp32 run of the
                   plain versions, no worse than the bf16 plain run's
                   (``MHA_ERR_RATIO``, ``MHA_ERR_FLOOR``); the (b, h, s, d)
                   kv_mask lane alone at the encdec shape, held and timed.
7. profiles      — first, row 18's CUDA launches over ten calls at each
                   of its kernel-phase shapes (one a call at T <= 32, two
                   above, nothing else); then the
                   O5 serve, the O5 speculative serve (self draft), the
                   Q8 serve over an int8 cache, the MoE serve at cf 8.0
                   and 1.25, one O5 and one O2 train
                   step of GPT-345M and of BERT-large (on bench.py's
                   all-ones mask), one GPT-345M step at seq 2048, one at
                   attention dropout 0.1, one staged BERT-large recipe
                   step with checkpointing on and one with it off, one
                   step of each side of the zero_adam pair and one
                   staged ResNet-50 step (device time split into cuDNN
                   convolutions, the optimizer kernel, max pool and the
                   plain batch norm and elementwise work)
                   under ``torch.profiler``: device time by kernel and
                   the device's idle share.  Last, since the profiler
                   slows every later launch.

8. dropout_faults — only when named: each fault of ``DROPOUT_FAULTS`` (a
                   head salt off by one in the backward's passes; the
                   keep compare >= written >) planted in a temporary copy
                   of the port, its source rebuilt there, and the keep
                   readback and 3 kernel and 3 plain train_dropout steps
                   run in that copy: each fault must be caught, and what
                   caught it is printed.
8'. recipe_faults — only when named: each of ``RECIPE_LOSS_FAULTS``
                   (LAMB phase 1's eps tenfold; row 4's sum without a
                   row's last 32 columns) planted in a copy, and leg c's
                   step medians on the routes it reaches: the readings
                   ``RECIPE_LOSS_TOL`` sits below.
9. numerics      — only when named: the flash forward's o and lse
                   against a float64 evaluation beside the plain
                   version's (signed and absolute error, bf16 flips), and
                   the O5 train steps' loss gaps to the plain version
                   seed by seed over ``TRAIN_SEEDS``, with the kernel
                   forward and with its o or its lse taken from the plain
                   version, and each forward's step medians (the numbers
                   the O5 train checks hold; ``train_spread`` run in a
                   copy with a planted fault reads that fault's).

``--phases`` runs a subset (``build`` always runs), for iterating.
When every default phase ran and passed, the last four lines are the whole
command's time, one JSON object ``{"kernels": [...]}``, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import importlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# --- tolerances -------------------------------------------------------
# kernel vs plain version, same bf16 inputs: both accumulate in fp32 and
# round the output to bf16 once, so they differ by about one bf16 ulp
# of the output (2^-8 relative) plus fp32 reassociation.
LN_TOL = 3e-2        # |y| up to ~4 for unit-normal rows: 1 ulp = 2^-6
ATTN_TOL = 1e-2      # |o| < 1 (a convex mix of unit-normal v rows)
LSE_TOL = 1e-3       # fp32 log-sum-exp
DECODE_TOL = 1e-2
# rows 14 and 15 element by element, beside DECODE_TOL: the kernel and its
# plain version both sum in fp32 and round once to the output's dtype, so each
# element lies within one ulp of that dtype (2^-7 of |ref| in bf16, 0 in
# fp32) plus DECODE_ATOL of fp32 noise.  At 16,384 positions |o| is about
# 0.01, so a split lost or counted twice in the merge of 64 moves
# elements by ~1e-3, which DECODE_TOL alone passes
DECODE_ULP_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
                   torch.float32: 0.0}
DECODE_ATOL = 1e-5
# row 14's cases beyond the serve's decode tick: (label, h, d, bs,
# max_pages, seq_lens held, seq_lens timed or None for the same): the
# long-context user's decode (one and two rows of 16,384 positions, each
# held with a seq_len-0 row beside it), and head dim 128 (GPT-345M's
# width in 8 heads) at the tick's lengths
DECODE_CASES = (
    ("long", 16, 64, 16, 1024, [16384, 0], [16384]),
    ("long", 16, 64, 16, 1024, [16384, 16384, 0], [16384, 16384]),
    ("d=128", 8, 128, 16, 64, [0, 16 * 20 + 7, 1024, 1, 700, 733, 64, 515],
     None),
)
# row 15's long-context verify, held beside the kernel phase's timed cases:
# (b, t, seq_lens), 1024 pages of 16
MULTI_LONG = (1, 3, [16384])
# int8 weight matmul, kernel vs plain version on the same inputs: both
# form the same fp32 products and differ by the order of K fp32 sums, so
# an fp32 out is held to 1e-5 of its largest value, and a bf16 out (both
# rounded once from fp32) to one bf16 ulp of each element beyond that same
# fp32 slack (an output whose sum cancels to near 0 carries the fp32 noise
# of its terms, many ulps of its own small value)
QMM_REL_TOL = 1e-5
QMM_ULPS = 1.0
# served token vs oracle argmax: a bf16 forward through other kernels
# and other matmul shapes moves a logit by a few hundredths at this
# width, so positions whose top-2 gap is below this are ties
TOKEN_GAP_TOL = 0.1
# the same check in fp32 (O0): kernels and plain versions agree to ~1e-6
TOKEN_GAP_TOL_FP32 = 2e-3
# the Q8 serve, bf16 activations over int8 weights (and an int8 cache held
# against the int8 replay): the tie rule of the bf16 serve
TOKEN_GAP_TOL_Q8 = 0.1
# MoE routing (row 18), kernel vs plain version on the same (x, logits,
# u): expert_index, slot, keep and the dispatch buffer (a row copy) must be
# exactly equal; the gates are the same fp32 expressions (the probability
# sums reassociated: JAX's own 1e-6), the aux loss an fp32 sum over
# tokens in another order (JAX's 1e-5 relative); the gradient through the
# Function's backward (the plain version at the saved inputs) against the
# plain version's own, both from the same fp32 expressions
MOE_GATE_TOL = 1e-6
MOE_AUX_RTOL = 1e-5
MOE_GRAD_TOL = 1e-6
# LayerNorm backward, bf16 x/dy/gamma: dx like the forward (one bf16 ulp
# at |dx| up to ~4); dgamma/dbeta are sums over 8192 rows rounded once to
# bf16, so they are held relative to their largest value (2.5 ulps)
LN_BWD_TOL = 3e-2
LN_WGRAD_RTOL = 1e-2
# LayerNorm backward with fp32 gamma: dgamma/dbeta stay fp32, so they are
# held against a float64 sum of the plain version's own terms (its fp32
# xhat, dy), relative to their largest value.  Only the kernel's fp32
# partial sums differ (about 1e-7); a walker that drops one of its rows,
# or a partial row left out, moves a column by one row's term or a
# sixteen-row sum of them (about 1e-2 of the largest).  The holds above
# pass both (one of 528 partials is ~0.2 % of a same-signed column).
LN_WGRAD_F64_RTOL = 1e-5
# E-layout flash backward, bf16.  Against its plain version on the same
# (qkv, o, lse, do): both compute in fp32 and round dqkv to bf16 once,
# so an element may differ by one bf16 ulp of the reference (at most
# 2^-7 of |ref|) plus the fp32 reassociation of sums of O(1) terms.
# Against autograd of the plain forward (delta from the unrounded o,
# the kernel's from o in bf16): relative Frobenius error of dq, dk and
# dv each, where bf16 rounding alone gives ~1e-3.
DQKV_ULP_RTOL = 2.0 ** -7
DQKV_ATOL = 1e-5
# The forwards of row 8's cases, the long E cases and the long_context
# phase hold o the same way, element by element: with bench_long_context's
# 0.5 * randn inputs at s = 4096-16384 the scores are nearly uniform and
# |o_i| is about 0.5 / sqrt(i + 1), so ATTN_TOL would be as large as the
# values it compares.  Sound kernels read an excess <= 1.1e-7; a forward
# that leaves keys 32-63 out of P.V (not of l) for rows >= 2048 reads
# 5.89e-3 at (1, 16, 8192, 64), a max |err| of 5.94e-3 that ATTN_TOL
# passed (PERF.md, Findings)
DQKV_FROB_RTOL = 5e-3
# Adam sweep: the same fp32 expression (contraction may differ by an
# ulp of the O(1) operands); the bf16 copy within one bf16 ulp
ADAM_TOL = 1e-6
# train: the plain versions round bf16 activations at other places over
# 24 layers, and Adam's first steps (~lr sign(g)) spread any difference,
# so one seed's gaps scatter over 2-3x between sound forwards, the same
# in every run (no kernel uses atomics).  The O5 GPT families
# (SEEDED_FAMILIES) therefore hold each step's median gap over
# TRAIN_SEEDS.  Over those seeds, five sound forwards (the fp32-pipe one,
# and four tensor-core ones that differ in the order and width of their
# fp32 sums) put the medians at most 1.06e-4, 1.14e-4 and 1.91e-4; a dQ
# pass that skips the last 32 keys of each diagonal tile 5.05e-5,
# 1.72e-4 and 1.98e-4, inside that spread here (train_long and the
# kernel phase's element holds catch it) (PERF.md, Findings)
TRAIN_LOSS_TOL = 2e-4
TRAIN_STEPS = 8
PLAIN_STEPS = 3
# the seeds whose median gap the O5 GPT and BERT families hold (the first
# is the train run's own), and those families
TRAIN_SEEDS = (0, 1, 2, 3, 4)
SEEDED_FAMILIES = ("gpt", "gpt_long", "gpt_dropout", "bert")
# fp16 builds of LayerNorm, forward and backward: each element within one
# fp16 ulp of its own reference value, 2^(floor(log2 |ref|) - 10) (both
# sides round one fp32 value once); below FP16_ULP_FLOOR of the largest
# |ref| the ulp at that floor, since fp32 sums of O(1) terms carry noise
# (~1e-6) that is many ulps of a value near 0.  (This replaced one
# absolute limit, the bf16 one scaled by 2^-3: one fp16 ulp only where
# |y| < 4, so a sound rounding flip at |y| >= 4 failed it.)
FP16_ULP_FLOOR = 2.0 ** -8
# causal softmax and its backward, fp32 scores: the same fp32 expression
# (exp and the row sum may differ by an ulp of values <= 1); the backward
# relative to max |dx|.  fp16 input: one fp16 ulp of a probability near
# 1 is 2^-11 ~ 4.9e-4
SOFTMAX_TOL = 1e-6
SOFTMAX_BWD_RTOL = 1e-6
SOFTMAX_FP16_TOL = 1e-3
# norm/finite sweep: fp32 sums of the same squares in another order
NORM_RTOL = 1e-5
# O2 train: plain vs kernel losses.  Sound kernels put the first 3 losses
# 1.91e-5 (the forward alone), 3.81e-6 and 2.86e-6 from the plain run's,
# the same in every run; a softmax backward that leaves the last 32
# columns of each row out of sum(y * dy) moves losses 2-3 by 3.91e-5 and
# 7.53e-5 (PERF.md, Findings)
TRAIN_O2_LOSS_TOL = 3e-5
OVERFLOW_SCALE = 2.0 ** 40
OVERFLOW_MAX_STEPS = 12
# LAMB phase 1: the same fp32 expression (contraction may differ by an
# ulp of the O(1) operands), relative to the largest |u|, |m|, |v|
LAMB_RTOL = 1e-6
# BERT-large, bench.py's batch: (rows, seq)
BERT_BATCH = (16, 512)
# BERT train, plain vs kernel losses over the first 3 steps, one limit a
# step.  Both recipes take large early steps at lr 1e-3 (the losses swing
# by whole nats over steps 1-4 in the kernel and the plain runs alike),
# which spreads a forward's rounding differences, and by seed: O5 (in
# SEEDED_FAMILIES) holds each step's median gap over TRAIN_SEEDS.  Three
# sound forwards (the kernel's, and its o or its lse swapped for the plain
# version's) read single-seed gaps from 1.3e-4 to 9.6e-2 (seeds 1 and 4
# alone past 2e-2 at steps 2-3), and medians at most 1.03e-3, 6.58e-3 and
# 3.09e-3; a kv_mask lane that drops each row's last real key (planted in
# the tensor-core forward) 6.24e-3, 1.63e-2 and 2.28e-2 (`train_spread`,
# the numerics phase, in copies).  The limits sit at the geometric means;
# steps 1 and 3 separate that fault with 2.4x on each side, step 2 with
# 1.5x.  The same drop planted in the dQ pass alone moves no median past
# 2.9e-3 (nor seed 0 past the old single-seed limits): the kernel phase's
# element holds are what catch it (PERF.md, Findings).  O2 (one seed): sound 4.77e-6,
# 4.56e-4 and 1.51e-3, the same in
# every run; a row 5 that leaves each live padded row's last key unmasked
# reads 4.22e-3, 1.21e-2 and 2.83e-3; a row 4 that leaves the last 32
# columns out of sum(y * dy) 4.77e-6 (step 1 is the forward alone),
# 2.54e-2 and 7.66e-2; a -inf fill in row 5 makes every loss NaN (PERF.md,
# Findings)
TRAIN_BERT_LOSS_TOL = (2.5e-3, 1e-2, 8e-3)
# train_bert_recipe: Megatron's arguments for BERT-large (bench.py:2315's
# shape) at their own defaults (attention and hidden dropout 0.1,
# --clip-grad 1.0, --weight-decay 0.01) plus --bf16
# --checkpoint-activations; the BERT phases' rate 1e-3, warmed up over
# RECIPE_WARMUP steps, then decayed linearly to 0 at --lr-decay-iters
RECIPE_ARGV = ("--num-layers 24 --hidden-size 1024 --num-attention-heads 16 "
               "--seq-length 512 --max-position-embeddings 512 "
               "--micro-batch-size 16 --vocab-size 30528 --lr 1e-3 "
               "--lr-decay-iters 10 --bf16 --checkpoint-activations").split()
RECIPE_WARMUP = 2
RECIPE_STEPS = 8
# the FusedMixedPrecisionLamb leg's step whose gradient carries an inf
RECIPE_MP_INF_STEP = 4
# leg c's routes: staged fused_lamb on the materialized scores (the
# provider's default), the same with use_flash, and the pipeline
RECIPE_ROUTES = ("staged", "flash", "pipeline")
# leg c, |kernel - plain| losses over the first PLAIN_STEPS steps, one
# limit a step and route, on the median over TRAIN_SEEDS.  At dropout 0.1
# the sound medians are staged 9.81e-4, 9.16e-4, 4.49e-3; flash 1.93e-4,
# 2.62e-3, 1.16e-2 (seed 1 alone reads 0.184 at step 3); pipeline
# 9.81e-4, 1.34e-3, 6.97e-3, the same in every run (every kernel of the
# path is deterministic).  Row 4 without a row's last 32 columns
# (RECIPE_LOSS_FAULTS) reads staged 7.76e-3, 5.05e-2 and pipeline
# 7.49e-3, 4.87e-2 at steps 2-3; LAMB phase 1 with a tenfold eps 0.154,
# 0.585 / 0.153, 0.523 / 0.152, 0.585 (step 1 is the forward alone).  The
# limits sit at the geometric means of the sound medians and the nearer
# fault's readings (PERF.md, Findings), step 1's at 3-5x its sound median
RECIPE_LOSS_TOL = {"staged": (3e-3, 2.7e-3, 1.5e-2),
                   "flash": (1e-3, 2e-2, 7.8e-2),
                   "pipeline": (3e-3, 3.2e-3, 1.8e-2)}
# leg f: the checkpoint wrapper planted without its generator replay
# (source under apex_tpu_torch/, then sound, faulty, ...): the recompute
# then draws fresh dropout, so the pair is no longer bitwise
RECIPE_CKPT_FAULT = ("transformer/tensor_parallel/random.py",
                     "for g, s in zip(gens, snap):",
                     "for g, s in zip(gens, ()):",
                     "for g, s in zip(gens, now):",
                     "for g, s in zip(gens, ()):")
# the faults ``--phases recipe_faults`` plants to read leg c's limits:
# (source, the routes it reaches, sound, faulty, ...): LAMB phase 1's
# eps ten times too large (every route), row 4's sum(y * dy) without a
# row's last 32 columns (the materialized routes)
RECIPE_LOSS_FAULTS = {
    "phase1_eps": ("csrc/fused_lamb.cu", RECIPE_ROUTES,
                   "(sqrtf(v / h.bc2) + h.eps)",
                   "(sqrtf(v / h.bc2) + 10.f * h.eps)"),
    "row4_sum": ("csrc/scaled_softmax.cu", ("staged", "pipeline"),
                 "if (c < sk) s = fmaf(yv[i], dv[i], s);",
                 "if (c < sk - 32) s = fmaf(yv[i], dv[i], s);"),
}
TRAIN_BERT_O2_LOSS_TOL = (5e-5, 2e-3, 2e-3)
# GPT-345M at seq 2048 (O5), plain vs kernel losses over the first 3
# steps, one limit a step, on the median over TRAIN_SEEDS (as the
# train's).  The five sound forwards put the medians at most 9.2e-5,
# 1.48e-4 and 1.34e-4; a dQ pass that skips the last 32 keys of each
# diagonal tile 5.91e-5 (step 1 is the forward alone), 1.81e-5 and
# 2.17e-4.  Seed 0 alone: a forward that drops each row's diagonal key
# moves step 1 by 1.11e-3 (and makes the later losses NaN); a dK/dV pass
# that skips the second 32-query sub-tile of each causal block 7.72e-5,
# 1.06e-2 and 1.40e-2 (PERF.md, Findings)
TRAIN_LONG_LOSS_TOL = (2e-4, 1.6e-4, 1.6e-4)
# bench.py's bench_long_context shapes (b, h, s, d), causal, bf16
LONG_CONTEXT_SHAPES = ((1, 16, 8192, 64), (1, 16, 16384, 64),
                       (1, 32, 4096, 128), (1, 16, 8192, 128),
                       (1, 16, 16384, 128))
# heads of a long-context shape held against the plain versions: as
# many as keep one plain (heads, s, s) fp32 tensor near 1 GiB
LONG_CONTEXT_PLAIN_ELEMS = 1 << 28
# row 8's kernel checks, (b, h, sq, sk, d, causal): the first is also
# held against autograd of the plain forward; those with sq == sk are
# timed (d = 64: the entry; d = 128: sub-entries of rows 8 and 6)
BWD_CASES = ((1, 16, 1024, 1024, 64, True), (1, 16, 384, 1000, 64, False),
             (1, 16, 384, 1000, 64, True), (1, 16, 1000, 384, 64, True),
             (1, 16, 1024, 1024, 128, True), (1, 16, 384, 1000, 128, True))
# row 8's and row 6's fp16 instantiations, held the same way (those with
# sq == sk timed)
BWD_FP16_CASES = ((1, 16, 1024, 1024, 64, True), (1, 16, 1024, 1024, 128, True),
                  (1, 16, 1000, 384, 128, True))
# the E kernels' long-slice checks, (b, s, h, d), causal: d = 128 on the
# single route (timed: sub-entries of rows 10/12), the long train step's
# shape on the blocked route (timed: rows 11/13), d = 128 blocked
E_LONG_CASES = ((2, 1024, 8, 128), (4, 2048, 16, 64), (1, 2048, 8, 128))
# the E kernels' time per (q, k) pair at a fixed token count
E_SWEEP_TOKENS, E_SWEEP_SEQS = 8192, (1024, 2048, 4096, 8192)
# attention dropout, the dropout lanes of rows 10-13, at bench.py's
# gpt2_345m_dropout rate.  Kernel cases (b, s, h, d, causal, kv_mask):
# GPT's step (timed: rows 10/12's entries), BERT's padded batch with an
# all-pad row (the kv_mask + dropout lane), d = 128, the long step's
# shape past a padded 1024 (the blocked walk's salted tiles; timed: rows
# 11/13's entries), and an odd head count at d = 64 with s not a multiple
# of 128 (JAX's fallback form, the hash's stride s itself)
DROPOUT_RATE = 0.1
DROPOUT_CASES = ((8, 1024, 16, 64, True, False), (16, 512, 16, 64, False, True),
                 (2, 1024, 8, 128, True, False), (4, 2048, 16, 64, True, False),
                 (2, 1000, 3, 64, True, False))
# the keep masks read back bit for bit, (b, s, h, d): the single route
# and the blocked walk; at this seed 5 and 8 of their pairs hash exactly
# onto the rate's threshold
DROPOUT_READBACK = ((2, 1024, 16, 64), (2, 2048, 16, 64))
DROPOUT_READBACK_SEED = 1001
# train_dropout (bench.py's gpt2_345m_dropout: attention dropout 0.1, no
# hidden dropout), plain vs kernel losses over the first 3 steps, one
# limit a step, on the median over TRAIN_SEEDS (as the train's).  The
# five sound forwards put the medians at most 1.17e-4, 1.21e-4 and
# 1.82e-4; a backward that hashes each pair with the next head's salt
# 6.01e-5 (step 1 is the forward alone), 4.63e-4 and 9.20e-4.  A keep
# compare written > for >= flips only the pairs hashing exactly onto the
# threshold (~100 of a step's 1.6e9): at seed 0 3.53e-5, 9.92e-5,
# 1.54e-4, inside the sound spread, so the keep readback
# (DROPOUT_READBACK, 13 such pairs) is what catches it (PERF.md,
# Findings)
TRAIN_DROPOUT_LOSS_TOL = (1.3e-4, 2e-4, 4e-4)
# the faults ``--phases dropout_faults`` plants in a copy of the port:
# (source, sound text, faulty text, ...); a head salt off by one in the
# backward's two passes only, and the keep compare >= written >
DROPOUT_FAULTS = {
    "bwd_head_salt": ("flash_attention_bwd.cu",
                      "dkey = drop_key(dr, bi, hi, j);",
                      "dkey = drop_key(dr, bi, hi + 1, j);",
                      "drow = drop_row(dr, bi, hi, i);",
                      "drow = drop_row(dr, bi, hi + 1, i);"),
    "keep_compare": ("flash_dropout.cuh", "return (x >> 8) >= thr;",
                     "return (x >> 8) > thr;"),
}

# the serve: 8 seeded prompt lengths in [64, 700], the last pinned to
# 700 so one prompt pads past 512 tokens (the gridded prefill case)
SERVE_LENGTHS = [int(x) for x in
                 np.random.RandomState(1234).randint(64, 701, 7)] + [700]
SERVE_NEW = 32
# serve_fast: speculation with K = 2 draft tokens (bench.py:961); the
# truncated draft is serve_smoke's (the target's first 22 of 24 layers);
# chunked prefill in chunks of two 16-token blocks
# (bench.py:1017), a request arriving every second tick; prefix sharing
# on bench.py:984-1012's trace: a 700-token system prompt plus 3 unique
# tokens, 4 requests of 4 new tokens
SPEC_K = 2
CHUNK = 32
SHARE_SYS, SHARE_REQUESTS, SHARE_NEW = 700, 4, 4
# serve_moe: every layer of the serve's model a Switch top-1 mixture of 8
# experts; capacity factor 8.0 (JAX's MoE serve: with E = 8 every step's
# capacity is its row count, nothing drops) and 1.25 (ServingModelConfig's
# default and bench.py:1757's: decode drops); the cf 1.25 leg's recorded
# rerun keeps every MOE_SAMPLE_EVERY-th prefill and decode routing call
MOE_EXPERTS = 8
MOE_NODROP_CF = 8.0
MOE_DROP_CF = 1.25
MOE_SAMPLE_EVERY = 25
# the ResNet slice: bench.py's bench_resnet50 (batch 256, 224x224, 1000
# classes, O5, fused_sgd(0.1, momentum=0.9, weight_decay=1e-4)); the
# staged route steps its 161 leaves in one leaf-table launch a dtype pair
# and table (``staged_launches``)
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 256, 224, 1000
RESNET_STEPS, RESNET_LEAVES = 8, 161
RESNET_ADAM_STEPS, RESNET_O2_STEPS, RESNET_EVAL_BATCH = 3, 4, 8
RESNET_ADAM_LR = 1e-3
# bench.py:92: a ResNet-50 train step is ~3 x 4.1 GFLOP an image
RN50_TRAIN_FLOPS_PER_IMG = 3 * 4.1e9
# the optimizer checks' odd-length buffer (the kernels' scalar tail)
OPT_ODD_N = 1_000_003
# the leaf-table steps' chunk sizes (elements a block) timed beside the
# default, ``fused_optim.STEP_CHUNK``
STEP_CHUNKS = (4096, 8192, 16384)
# (nesterov, dampening, wd_after_momentum, first_run)
SGD_FLAGS = ((False, 0.0, False, False), (True, 0.0, False, False),
             (False, 0.1, True, False), (False, 0.1, False, True),
             (True, 0.0, True, True))
# ResNet-50 train, kernel vs plain (and pipeline vs staged), over the first
# PLAIN_STEPS steps on cuDNN's deterministic algorithms, one limit a step:
# the optimizer kernels equal their plain versions bit for bit, so sound
# kernels read 0 at every step; an SGD kernel with the weight decay's sign
# flipped reads 0 (step 1 is the forward alone), 6.08e-3 and 7.27e-3, one
# that freezes every fourth element 0, 0.214 and 0.053 (PERF.md, Findings)
TRAIN_RESNET_LOSS_TOL = (1e-6, 1e-4, 1e-4)
# the faults ``--phases resnet_faults`` plants in a copy of fused_sgd.cu to
# show that TRAIN_RESNET_LOSS_TOL catches them: (sound line, faulty line)
RESNET_FAULTS = {
    "wd_sign": ("g = __fadd_rn(g, __fmul_rn(h.wd, p));",
                "g = __fsub_rn(g, __fmul_rn(h.wd, p));"),
    "every_4th_frozen": ("sgd_one(gg[u][e], pp[u][e], mm[u][e], t.h, true);",
                         "sgd_one(gg[u][e], pp[u][e], mm[u][e], t.h, e != 3);"),
}
# the eval forward (train=False) in bf16 against the same weights in fp32
# compute: bf16 rounds ~50 layers of activations (measured 2.2e-3 of
# max |logit| on the CPU)
RESNET_EVAL_RTOL = 2e-2

# the update slice (row 19's four optax-style update bodies): the kernel
# checks' timing length, row 19's other rows' (bf16 g, fp32 p)
UPDATE_N = 67_108_864
UPDATE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
UPDATE_ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                   weight_decay=0.01, bias_correction1=1 - 0.9 ** 3,
                   bias_correction2=1 - 0.999 ** 3)
UPDATE_ADAGRAD = dict(lr=1e-2, eps=1e-10, weight_decay=0.01)
UPDATE_NOVOGRAD = dict(lr=1e-3, beta1=0.95, weight_decay=0.01,
                       bias_correction1=1 - 0.95 ** 3)
UPDATE_SGD = dict(lr=0.1, momentum=0.9, weight_decay=0.01)
# bytes an element each body moves at bf16 g, fp32 p (g 2, p 4 and each
# fp32 state 4 read; the fp32 delta and each new state 4 written) and its
# fp32 operations an element (AdamW, Adagrad, NovoGrad, SGD without
# Nesterov, decay before the momentum)
UPDATE_BYTES = {"adam_update": 26, "adagrad_update": 18,
                "novograd_update": 22, "sgd_update": 18}
UPDATE_FLOPS = {"adam_update": 15, "adagrad_update": 8,
                "novograd_update": 8, "sgd_update": 6}
# bench.py's bench_zero_adam: _synthetic_params(355_000_000) (8 leaves of
# (43334, 1024), one (7, 1024), one (1, 1024): 355,000,320 fp32
# elements), g = p * 1e-3 + 1e-3, g_t = g + 1e-12 p inside each of K = 8
# steps, fused_adam(1e-3) dense against distributed_fused_adam(1e-3) on a
# one-rank group
ZERO_SHAPES = ((43_334, 1024),) * 8 + ((7, 1024), (1, 1024))
ZERO_STEPS = 8
ZERO_LR = 1e-3
# bench.py's small_leaves_26m_packed (_synthetic_params(26_000_000,
# leaf_elems=65_536)): 396 leaves of (64, 1024), one (46, 1024), one (1,
# 1024), 26,000,384 fp32 elements, every leaf packed (DIRECT_MIN_ELEMS
# raised above the leaf size): 256 leaves fill the first 2^24-element
# chunk and 142 the second, so 2 launches a step an optimizer
OPTIM_SHAPES = ((64, 1024),) * 396 + ((46, 1024), (1, 1024))
OPTIM_STEPS = 8
OPTIM_GROUPS = 2
# the ring slice: bench.py's bench_ring_flash substep (b, h, s_local, d),
# bf16, the partial at q_offset = s_local, k_offset = 0; its dropout
# substep at rate 0.1 as the rank holding heads 16..31 of a head-split
# ring; the diagonal, wholly future and dropout cases at s = 1024; the
# keep-mask readback's shape, and a seed whose hash puts 3 of its
# 33,554,432 pairs exactly on the threshold (a compare written > for >=
# must then fail)
RING_SHAPE = (1, 16, 8192, 64)
RING_DROPOUT = 0.1
RING_SEED = 1201
RING_HEAD_OFFSET = 16
RING_CASES_S = 1024
RING_READBACK = (2, 16, 1024, 64)
RING_READBACK_SEED = 3001
# flash_attention_qkv at GPT-345M's attention (causal) and BERT-large's
# (its padding mask): (b, h, s, d, causal, kv_mask)
QKV_CASES = ((8, 16, 1024, 64, True, False), (16, 16, 512, 64, False, True))
# contrib.multihead_attn at GPT-345M width; the self module at (b, s), the
# encdec module at (b, tq, tk).  The bf16 module on the kernels and its
# bf16 twin on the plain versions are both held against an fp32 run of the
# plain versions: for the output and every gradient, the kernels' ||err||
# / ||ref|| may be at most MHA_ERR_RATIO times the plain twin's plus
# MHA_ERR_FLOOR.  The key projection's bias takes no part: its gradient is
# 0 analytically (a bias on every key shifts a row's scores by one
# constant), so each side holds only rounding noise, and the flash
# backward's delta = rowsum(dO o) from the stored bf16 o (as JAX's kernels
# form it) leaves more of it than autograd's exact softmax; it is printed.
MHA_EMBED, MHA_HEADS = 1024, 16
MHA_SELF = (16, 512)
MHA_ENCDEC = (16, 256, 512)
MHA_ERR_RATIO = 2.0
MHA_ERR_FLOOR = 1e-3

# row 18's cases: bench.py's bench_moe_ep shape (T 4096, H 256, E 8, fp32
# x) at top1/all (capacity 640), top2/all and top2/random (1280); the MoE
# serve's shapes (E 8, bf16 x): the decode tick's 8 rows and the 700-token
# prompt's 1024 padded rows at capacity factors 8.0 and 1.25; shapes off
# every grain (E 5 and 40, H 100, T 130 and 33); and T = 32 and 33, the
# last one-launch and the first two-launch call, top2/random with drops
MOE_CASES = (
    ("bench_moe_ep top1", 4096, 256, 8, 640, 1, "all", torch.float32),
    ("bench_moe_ep top2", 4096, 256, 8, 1280, 2, "all", torch.float32),
    ("bench_moe_ep top2 random", 4096, 256, 8, 1280, 2, "random",
     torch.float32),
    ("serve decode cf 8", 8, 1024, 8, 8, 1, "all", torch.bfloat16),
    ("serve decode cf 1.25", 8, 1024, 8, 1, 1, "all", torch.bfloat16),
    ("serve prefill cf 8", 1024, 1024, 8, 1024, 1, "all", torch.bfloat16),
    ("serve prefill cf 1.25", 1024, 1024, 8, 160, 1, "all", torch.bfloat16),
    ("off grain", 130, 100, 5, 33, 2, "random", torch.float32),
    ("off grain, E > T", 33, 100, 40, 1, 2, "all", torch.bfloat16),
    ("one-launch boundary T 32", 32, 1024, 8, 6, 2, "random",
     torch.bfloat16),
    ("two-launch boundary T 33", 33, 1024, 8, 6, 2, "random",
     torch.bfloat16))
# CUDA launches a row-18 call makes: one at T <= 32, two above
MOE_ONE_LAUNCH_T = 32

# --- the card (NVIDIA H100 SXM data sheet, dense) ----------------------
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP16_FLOPS = 989e12
FP32_FLOPS = 67e12

REPLACES = {
    "layer_norm": "apex_tpu/ops/layer_norm.py:62",
    "flash_attention": "apex_tpu/ops/flash_attention.py:556",
    "flash_decode": "apex_tpu/ops/flash_decode.py:198",
    "flash_decode_multi": "apex_tpu/ops/flash_decode.py:385",
    "layer_norm_bwd": "apex_tpu/ops/layer_norm.py:127",
    "flash_attention_e": "apex_tpu/ops/flash_attention.py:1927",
    "flash_attention_e_bwd": "apex_tpu/ops/flash_attention.py:2211",
    "fused_adam_pipeline": "apex_tpu/ops/fused_optim.py:109",
    "scaled_softmax_causal_fwd": "apex_tpu/ops/scaled_softmax.py:88",
    "scaled_softmax_bwd": "apex_tpu/ops/scaled_softmax.py:115",
    "norm_finite": "apex_tpu/ops/fused_pipeline.py:252",
    "quant_gemv": "apex_tpu/ops/quant_matmul.py:122",
    "quant_tiled": "apex_tpu/ops/quant_matmul.py:150",
    "flash_decode_int8": "apex_tpu/ops/flash_decode.py:137",
    "flash_decode_multi_int8": "apex_tpu/ops/flash_decode.py:325",
    "scaled_masked_softmax_fwd": "apex_tpu/ops/scaled_softmax.py:185",
    "flash_attention_e_kvmask": "apex_tpu/ops/flash_attention.py:1927",
    "flash_attention_e_bwd_kvmask": "apex_tpu/ops/flash_attention.py:2211",
    "lamb_phase1": "apex_tpu/ops/fused_optim.py:262",
    "flash_attention_bwd": "apex_tpu/ops/flash_attention.py:1027",
    "flash_attention_e_blocked": "apex_tpu/ops/flash_attention.py:2067",
    "flash_attention_e_bwd_blocked": "apex_tpu/ops/flash_attention.py:2404",
    "moe_route_dispatch": "apex_tpu/ops/moe_routing.py:145",
    "sgd_step": "apex_tpu/ops/fused_optim.py:393",
    "adam_step": "apex_tpu/ops/fused_optim.py:220",
    "sgd_pipeline": "apex_tpu/ops/fused_pipeline.py:453",
    "flash_attention_e_dropout": "apex_tpu/ops/flash_attention.py:1913",
    "flash_attention_e_bwd_dropout": "apex_tpu/ops/flash_attention.py:2191",
    "flash_attention_e_blocked_dropout":
        "apex_tpu/ops/flash_attention.py:2043",
    "flash_attention_e_bwd_blocked_dropout":
        "apex_tpu/ops/flash_attention.py:2336",
    "adam_update": "apex_tpu/ops/fused_optim.py:170",
    "adagrad_update": "apex_tpu/ops/fused_optim.py:253",
    "novograd_update": "apex_tpu/ops/fused_optim.py:323",
    "sgd_update": "apex_tpu/ops/fused_optim.py:356",
    "flash_attention_partial": "apex_tpu/ops/flash_attention.py:556",
    "flash_attention_partial_bwd": "apex_tpu/ops/flash_attention.py:1027",
    "flash_attention_partial_dropout": "apex_tpu/ops/flash_attention.py:258",
    "flash_attention_partial_bwd_dropout":
        "apex_tpu/ops/flash_attention.py:258",
    "flash_attention_kvmask": "apex_tpu/ops/flash_attention.py:1409",
    "flash_attention_bwd_kvmask": "apex_tpu/ops/flash_attention.py:1426",
    "flash_attention_qkv": "apex_tpu/ops/flash_attention.py:671",
    "flash_attention_qkv_bwd": "apex_tpu/ops/flash_attention.py:1205",
}
SOURCES = {
    "layer_norm": "apex_tpu_torch/csrc/layer_norm.cu",
    "flash_attention": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_decode": "apex_tpu_torch/csrc/flash_decode.cu",
    "flash_decode_multi": "apex_tpu_torch/csrc/flash_decode.cu",
    "layer_norm_bwd": "apex_tpu_torch/csrc/layer_norm.cu",
    "flash_attention_e": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_e_bwd": "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_adam_pipeline": "apex_tpu_torch/csrc/fused_adam.cu",
    "scaled_softmax_causal_fwd": "apex_tpu_torch/csrc/scaled_softmax.cu",
    "scaled_softmax_bwd": "apex_tpu_torch/csrc/scaled_softmax.cu",
    "norm_finite": "apex_tpu_torch/csrc/norm_finite.cu",
    "quant_gemv": "apex_tpu_torch/csrc/quant_matmul.cu",
    "quant_tiled": "apex_tpu_torch/csrc/quant_matmul.cu",
    "flash_decode_int8": "apex_tpu_torch/csrc/flash_decode.cu",
    "flash_decode_multi_int8": "apex_tpu_torch/csrc/flash_decode.cu",
    "scaled_masked_softmax_fwd": "apex_tpu_torch/csrc/scaled_softmax.cu",
    "flash_attention_e_kvmask": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_e_bwd_kvmask":
        "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "lamb_phase1": "apex_tpu_torch/csrc/fused_lamb.cu",
    "flash_attention_bwd": "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_e_blocked": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_e_bwd_blocked":
        "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "moe_route_dispatch": "apex_tpu_torch/csrc/moe_routing.cu",
    "sgd_step": "apex_tpu_torch/csrc/fused_sgd.cu",
    "adam_step": "apex_tpu_torch/csrc/fused_adam.cu",
    "sgd_pipeline": "apex_tpu_torch/csrc/fused_sgd.cu",
    "flash_attention_e_dropout": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_e_bwd_dropout":
        "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_e_blocked_dropout":
        "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_e_bwd_blocked_dropout":
        "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "adam_update": "apex_tpu_torch/csrc/fused_optim_update.cu",
    "adagrad_update": "apex_tpu_torch/csrc/fused_optim_update.cu",
    "novograd_update": "apex_tpu_torch/csrc/fused_optim_update.cu",
    "sgd_update": "apex_tpu_torch/csrc/fused_optim_update.cu",
    "flash_attention_partial":
        "apex_tpu_torch/csrc/flash_attention_partial.cu",
    "flash_attention_partial_bwd":
        "apex_tpu_torch/csrc/flash_attention_partial.cu",
    "flash_attention_partial_dropout":
        "apex_tpu_torch/csrc/flash_attention_partial.cu",
    "flash_attention_partial_bwd_dropout":
        "apex_tpu_torch/csrc/flash_attention_partial.cu",
    "flash_attention_kvmask": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_kvmask":
        "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_qkv": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_qkv_bwd": "apex_tpu_torch/csrc/flash_attention_bwd.cu",
}
# the path each kernel's launches are counted on
SERVE_KERNELS = ("layer_norm", "flash_attention", "flash_decode")
SERVE_FAST_KERNELS = ("layer_norm", "flash_attention", "flash_decode",
                      "flash_decode_multi")
Q8_CHECKS = ("flash_decode_int8", "flash_decode_multi_int8", "quant_matmul")
SERVE_Q8_KERNELS = ("layer_norm", "flash_attention", "flash_decode",
                    "flash_decode_int8", "flash_decode_multi_int8",
                    "quant_gemv", "quant_tiled")
TRAIN_KERNELS = ("layer_norm", "layer_norm_bwd", "flash_attention_e",
                 "flash_attention_e_bwd", "fused_adam_pipeline")
TRAIN_O2_KERNELS = ("layer_norm", "layer_norm_bwd",
                    "scaled_softmax_causal_fwd", "scaled_softmax_bwd",
                    "norm_finite", "fused_adam_pipeline")
TRAIN_BERT_KERNELS = ("layer_norm", "layer_norm_bwd",
                      "flash_attention_e_kvmask",
                      "flash_attention_e_bwd_kvmask", "norm_finite",
                      "lamb_phase1")
TRAIN_BERT_O2_KERNELS = ("layer_norm", "layer_norm_bwd",
                         "scaled_masked_softmax_fwd", "scaled_softmax_bwd",
                         "norm_finite", "fused_adam_pipeline")
TRAIN_BERT_RECIPE_KERNELS = ("layer_norm", "layer_norm_bwd",
                             "scaled_masked_softmax_fwd",
                             "scaled_softmax_bwd",
                             "flash_attention_e_dropout",
                             "flash_attention_e_bwd_dropout",
                             "norm_finite", "lamb_phase1")
SERVE_MOE_KERNELS = ("layer_norm", "flash_attention", "flash_decode",
                     "moe_route_dispatch")
LONG_CONTEXT_KERNELS = ("flash_attention", "flash_attention_bwd")
TRAIN_LONG_KERNELS = ("layer_norm", "layer_norm_bwd",
                      "flash_attention_e_blocked",
                      "flash_attention_e_bwd_blocked", "fused_adam_pipeline")
TRAIN_RESNET_KERNELS = ("sgd_step", "adam_step", "sgd_pipeline")
TRAIN_DROPOUT_KERNELS = ("layer_norm", "layer_norm_bwd",
                         "flash_attention_e_dropout",
                         "flash_attention_e_bwd_dropout",
                         "fused_adam_pipeline")
TRAIN_DROPOUT_LONG_KERNELS = ("layer_norm", "layer_norm_bwd",
                              "flash_attention_e_blocked_dropout",
                              "flash_attention_e_bwd_blocked_dropout",
                              "fused_adam_pipeline")
ZERO_ADAM_KERNELS = ("adam_update",)
RING_FLASH_KERNELS = ("flash_attention_partial", "flash_attention_partial_bwd",
                      "flash_attention_partial_dropout",
                      "flash_attention_partial_bwd_dropout")
FLASH_QKV_KERNELS = ("flash_attention_qkv", "flash_attention_qkv_bwd")
MHA_KERNELS = ("flash_attention_e_kvmask", "flash_attention_e_bwd_kvmask",
               "flash_attention_e", "flash_attention_e_bwd",
               "flash_attention_kvmask", "flash_attention_bwd_kvmask",
               "layer_norm", "layer_norm_bwd")
OPTIM_UPDATE_KERNELS = ("adam_update", "adagrad_update", "novograd_update",
                        "sgd_update")
# the kernel checks that draw from a generator of their own (the Q8
# tier's, the BERT phases', the long-context, MoE, ResNet, dropout and
# update slices'), so the earlier checks keep their inputs
BERT_CHECKS = ("grad_routing", "scaled_masked_softmax",
               "flash_attention_e_kvmask", "lamb_phase1")
LONG_CHECKS = ("flash_attention_bwd", "flash_attention_e_long")
MOE_CHECKS = ("moe_routing",)
RESNET_CHECKS = ("sgd_step", "adam_step", "sgd_pipeline")
DROPOUT_CHECKS = ("flash_attention_e_dropout",)
UPDATE_CHECKS = ("optim_update",)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 30, warmup: int = 3):
    """``(device_ms, wall_ms)`` per call of ``fn()``, by CUDA events.

    ``wall_ms``: ``iters`` calls back to back, as a caller issues them;
    where the host launches slower than the device runs, this is the
    host's time.  ``device_ms``: calls queued behind a sleeping kernel
    (``torch.cuda._sleep``) so the device runs them without waiting for
    the host.  The sleep must outlast the issue: when it does not (a
    plain version of many small kernels can fill the launch queue and
    block the host), the count is halved and the measure repeated."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    n = iters
    while True:
        sleep_ms = 3 * n * wall + 20
        # at most 1.98e6 cycles a millisecond (the H100's top SM clock)
        torch.cuda._sleep(int(sleep_ms * 1.98e6))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        issued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issued_ms < 0.8 * sleep_ms:
            return start.elapsed_time(end) / n, wall
        if n == 1:
            raise RuntimeError(f"issuing one call took {issued_ms:.2f} "
                               f"ms, longer than the sleep that hides it")
        n //= 2


def time_ms_wall(fn, iters: int = 10, warmup: int = 2) -> float:
    """ms per call of ``fn()`` issued back to back, by CUDA events (the
    wall a caller sees)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def misaligned(t):
    """``t``'s values in a contiguous view one element past a 16-byte
    boundary: the softmax kernels' element path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view_as(t).copy_(t)


def grad_excess(got, ref) -> float:
    """max over elements of |got - ref| beyond one bf16 ulp of the
    reference (``DQKV_ULP_RTOL`` |ref|): the flash kernels'
    element-by-element measure against their plain versions (the
    gradients, and o in the long-context checks)."""
    diff = (got.float() - ref.float()).abs()
    return float((diff - DQKV_ULP_RTOL * ref.float().abs()).max())


def decode_excess(got, ref) -> float:
    """max over elements of |got - ref| beyond one ulp of the output's
    dtype (``DECODE_ULP_RTOL`` |ref|): rows 14 and 15's element hold."""
    diff = (got.float() - ref.float()).abs()
    return float((diff - DECODE_ULP_RTOL[got.dtype]
                  * ref.float().abs()).max())


def rel_err(a, b) -> float:
    """max |a - b| over max |b|: the error relative to the output's
    scale (printed beside the absolute error the tolerance holds)."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# --- phase 1 ------------------------------------------------------------

def phase_build():
    from apex_tpu_torch import _build

    ver = subprocess.run([_build.nvcc_path(), "--version"],
                         capture_output=True, text=True).stdout
    rel = [ln for ln in ver.splitlines() if "release" in ln]
    log(f"build: nvcc {rel[0].strip() if rel else ver.strip()} (the "
        f"leaf-table steps keep a 4 KB parameter block, every toolkit's "
        f"limit)")
    t0 = time.perf_counter()
    built = _build.build()
    dt = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.library(name)
    log(f"build: {len(built)} librar{'y' if len(built) == 1 else 'ies'} "
        f"compiled in {dt:.1f} s ({', '.join(built) or 'cached'})")
    for name, text in _build.LOGS.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or \
                    "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    check_tensor_cores(_build)


# the tensor-core flash kernels (`csrc/flash_fwd.cuh`'s forward,
# `csrc/flash_bwd.cuh`'s dK/dV and dQ passes): name, template arguments
# (T, D, kMask, kDrop, kOff) as they appear in the mangled symbol
_MMA_KERNEL = re.compile(r"(mma_fwd_kernel|mma_dkv_kernel|mma_dq_kernel)"
                         r"I(13__nv_bfloat16|6__half)"
                         r"Li(\d+)ELb([01])ELi(\d)ELb([01])E")
# the (b, h, s, d) / qkv / E entries' lanes (kv_mask x tile hash) and the
# partial entry's (offsets, with or without the coordinate hash)
_ENTRY_LANES = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0))
_PARTIAL_LANES = ((0, 0, 1), (0, 2, 1))
# each library's tensor-core kernels and the lanes (kMask, kDrop, kOff) it
# instantiates for each, in bf16 and fp16 at d = 64 and 128
MMA_LANES = {
    "flash_attention": {"mma_fwd_kernel": _ENTRY_LANES},
    "flash_attention_bwd": {"mma_dkv_kernel": _ENTRY_LANES,
                            "mma_dq_kernel": _ENTRY_LANES},
    "flash_attention_partial": {"mma_fwd_kernel": _PARTIAL_LANES,
                                "mma_dkv_kernel": _PARTIAL_LANES,
                                "mma_dq_kernel": _PARTIAL_LANES}}


def _mma_smem(kernel: str, d: int) -> int:
    """The dynamic shared memory of a tensor-core kernel (``fwd_smem``,
    ``dkv_smem`` and ``dq_smem`` in ``csrc/``): the own 64-row tiles and
    two stages of the walked ones, rows of d + 8 two-byte elements, and
    the dK/dV pass's two stages of fp32 lse2 and delta."""
    if kernel == "mma_fwd_kernel":
        return (64 + 4 * 64) * (d + 8) * 2
    walk = 64 if kernel == "mma_dq_kernel" or d == 64 else 32
    if kernel == "mma_dq_kernel":
        return (2 * 64 + 4 * walk) * (d + 8) * 2
    return (2 * 64 + 4 * walk) * (d + 8) * 2 + 4 * walk * 4


def _ptxas_usage(text: str) -> dict:
    """``ptxas -v``'s registers and spill bytes for each function of one
    build log: mangled name -> (registers, spill stores, spill loads)."""
    out, cur, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), *spills)
            cur, spills = None, (0, 0)
    return out


def _res_usage(tool: str, lib: Path) -> dict:
    """``cuobjdump -res-usage`` of a built library: mangled name ->
    (registers, stack bytes); the usage of a library this process did not
    compile, whose ``ptxas -v`` log it never saw."""
    text = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {m.group(1): (int(m.group(2)), int(m.group(3)))
            for m in re.finditer(r"Function (\S+?):?\s+REG:(\d+) STACK:(\d+)",
                                 text)}


def check_tensor_cores(_build) -> None:
    """Every bf16 and fp16 instantiation of the flash forward and of the
    backward's dK/dV and dQ passes must run on the tensor cores:
    ``cuobjdump -sass`` of the three libraries that hold them shows
    ``HMMA`` in each, each expected instantiation is there, and no
    forward spills (the fp16 d = 128 dK/dV passes do, a few hundred
    bytes).  Prints each one's HMMA count, registers and spills (from
    this build's ``ptxas -v``, or for a library built earlier its
    registers and stack frame from ``cuobjdump -res-usage``) and dynamic
    shared memory."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).parent / "cuobjdump")
    spilled = []
    for lib, kernels in MMA_LANES.items():
        path = _build.lib_path(lib)
        sass = subprocess.run([tool, "-sass", str(path)],
                              capture_output=True, text=True, check=True).stdout
        usage = _ptxas_usage(_build.LOGS.get(lib, ""))
        res = {} if usage else _res_usage(tool, path)
        found = {}
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            name = block.split(None, 1)[0]
            m = _MMA_KERNEL.search(name)
            if m:
                found[m.groups()] = (name, block.count("HMMA"))
        want = {(k, t, str(d), str(lm), str(ld), str(lo))
                for k, lanes in kernels.items()
                for t in ("13__nv_bfloat16", "6__half") for d in (64, 128)
                for lm, ld, lo in lanes}
        bad = sorted(k for k in want if found.get(k, ("", 0))[1] == 0)
        for key in sorted(found):
            kernel, t, d, lm, ld, lo = key
            name, hmma = found[key]
            if name in usage:
                regs, stores, loads = usage[name]
                use = (f"{regs} registers, {stores} B spill stores, "
                       f"{loads} B spill loads")
                spills = stores or loads
            elif name in res:
                regs, stack = res[name]
                use = (f"{regs} registers, {stack} B stack frame "
                       f"(cuobjdump -res-usage: built earlier)")
                spills = stack
            else:
                use, spills = "usage not read", 0
            if kernel == "mma_fwd_kernel" and spills:
                spilled.append(f"{lib}: {name}")
            log(f"  tensor cores {lib}: {kernel} "
                f"{'bf16' if 'bfloat' in t else 'fp16'} d={d} kv_mask={lm} "
                f"drop={ld} offsets={lo}: {hmma} HMMA, {use}, "
                f"{_mma_smem(kernel, int(d))} B dynamic shared memory")
        if bad or set(found) != want:
            raise AssertionError(
                f"{lib}: tensor-core kernels without HMMA or missing: {bad}; "
                f"unexpected: {sorted(set(found) - want)}")
    if spilled:
        raise AssertionError(f"forward kernels that spill: {spilled}")
    log(f"tensor cores: every bf16/fp16 forward, dK/dV and dQ kernel of "
        f"{', '.join(MMA_LANES)} holds HMMA; no forward spills")
    check_quant_tensor_cores(_build, tool)


# rows 16 and 17's tensor-core kernels (`csrc/quant_matmul.cu`) and their
# dynamic shared memory: the small kernel's four warps' [32][64] fp32
# partials; the staged kernel's three stages of 64 x rows ([64][72]
# elements) and 64 raw code rows (144 bytes each); the GEMV's
# (`_qmm_smem`): its warps' [8][128] fp32 partials, then an inbox of that
# size again and 8 float4s of slack
QMM_KERNELS = {"quant_small_kernel": 4 * 32 * 64 * 4,
               "quant_mma_kernel": 3 * (64 * 72 * 2 + 64 * 144)}
# x bf16/fp16 x out x's/fp32 x VEC: 8 of each of row 17's kernels, and of
# the GEMV at 4 and at 8 warps a block
QMM_INSTANTIATIONS = 32
_QMM_KERNEL = re.compile(r"(quant_gemv_mma_kernel|quant_small_kernel|"
                         r"quant_mma_kernel)I(13__nv_bfloat16|6__half)")


def _qmm_smem(kernel: str, symbol: str) -> int:
    """Dynamic shared memory of one instantiation (the GEMV's by its
    warps, the template's last argument)."""
    if kernel == "quant_gemv_mma_kernel":
        warps = int(re.search(r"Lb[01]ELi(\d+)E", symbol).group(1))
        return (warps + 1) * 8 * 128 * 4 + 8 * 16
    return QMM_KERNELS[kernel]


def check_quant_tensor_cores(_build, tool: str) -> None:
    """Every bf16 and fp16 instantiation of row 16's GEMV
    (``quant_gemv_mma_kernel``: x's dtype x out's x VEC x 4 or 8 warps)
    and of row 17's kernels (``quant_small_kernel`` and
    ``quant_mma_kernel``: x's dtype x out's x VEC), 32 in all, must run on
    the tensor cores: ``cuobjdump -sass`` of
    ``quant_matmul`` shows ``HMMA`` in each.  Prints each one's HMMA
    count, registers and spills (or, for a library an earlier process
    built, its registers and stack frame) and dynamic shared memory."""
    path = _build.lib_path("quant_matmul")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    usage = _ptxas_usage(_build.LOGS.get("quant_matmul", ""))
    res = {} if usage else _res_usage(tool, path)
    found = []
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split(None, 1)[0]
        m = _QMM_KERNEL.search(name)
        if not m:
            continue
        hmma = block.count("HMMA")
        if name in usage:
            regs, stores, loads = usage[name]
            use = (f"{regs} registers, {stores} B spill stores, {loads} B "
                   f"spill loads")
        elif name in res:
            use = (f"{res[name][0]} registers, {res[name][1]} B stack frame "
                   f"(cuobjdump -res-usage: built earlier)")
        else:
            use = "usage not read"
        log(f"  tensor cores quant_matmul: {m.group(1)} "
            f"{'bf16' if 'bfloat' in m.group(2) else 'fp16'} ({name}): "
            f"{hmma} HMMA, {use}, {_qmm_smem(m.group(1), name)} B dynamic "
            f"shared memory")
        found.append((name, hmma))
    bad = [n for n, h in found if h == 0]
    if len(found) != QMM_INSTANTIATIONS or bad:
        raise AssertionError(f"quant_matmul: {len(found)} rows-16/17 "
                             f"tensor-core instantiations "
                             f"({QMM_INSTANTIATIONS} expected); without "
                             f"HMMA: {bad}")
    log(f"tensor cores: every bf16/fp16 instantiation of rows 16 and 17's "
        f"kernels ({QMM_INSTANTIATIONS}) holds HMMA")


# --- phase 2 ------------------------------------------------------------

def ln_paths_equal(x, gamma, beta):
    """Row 1's vector path (``x`` as given, 16-byte aligned) against its
    element path (the same values through a view one element off 16-byte
    alignment): whether y, mean and rstd are equal bit for bit."""
    from apex_tpu_torch.ops import layer_norm_with_stats

    vec = layer_norm_with_stats(x, gamma, beta, 1e-5)
    elem = layer_norm_with_stats(misaligned(x), gamma, beta, 1e-5)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(vec, elem))


def check_layer_norm(dev, g):
    """Row 1 at the serve's shapes (a decode tick's 8 rows, the longest
    prefill's 1024), bf16 x with fp32 gamma/beta: held to the plain
    version, and the vector path's y, mean and rstd bit for bit the element
    path's (``ln_paths_equal``)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm_with_stats
    from apex_tpu_torch.ops.layer_norm import layer_norm_stats_reference

    hd = 1024
    entry = None
    for rows in (8, 1024):       # a decode batch, the longest prefill
        x = torch.randn(rows, hd, generator=g, device=dev).bfloat16()
        gamma = (1 + 0.1 * torch.randn(hd, generator=g, device=dev))
        beta = 0.1 * torch.randn(hd, generator=g, device=dev)
        y, mean, rstd = layer_norm_with_stats(x, gamma, beta, 1e-5)
        torch.cuda.synchronize()
        yr, mr, rr = layer_norm_stats_reference(x, gamma, beta, 1e-5)
        err = max_err(y, yr)
        stat_err = max(max_err(mean, mr), max_err(rstd, rr))
        same = ln_paths_equal(x, gamma, beta)
        ok = err <= LN_TOL and stat_err <= 1e-4 and same
        log(f"kernel layer_norm rows={rows} hidden={hd} bf16 x, fp32 "
            f"gamma: max_abs_err={err:.3e} (tol {LN_TOL}) "
            f"max_rel_err={rel_err(y, yr):.3e} "
            f"stats_err={stat_err:.3e} (tol 1e-4), vector path y/mean/rstd "
            f"bitwise the element path's: {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("layer_norm kernel disagrees")
        ms, ms_w = time_ms(
            lambda: layer_norm_with_stats(x, gamma, beta, 1e-5))
        plain, plain_w = time_ms(
            lambda: layer_norm_stats_reference(x, gamma, beta, 1e-5))
        gb, bb = gamma.bfloat16(), beta.bfloat16()
        lib, lib_w = time_ms(lambda: F.layer_norm(x, (hd,), gb, bb, 1e-5))
        nbytes = 2 * rows * hd * 2 + 2 * hd * 4 + 2 * rows * 4
        flops = 8.0 * rows * hd
        b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOPS)
        log(f"  time rows={rows}, device ms (wall ms per call): kernel "
            f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
            f"F.layer_norm {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} "
            f"({b_by})")
        entry = dict(name="layer_norm", shape=f"({rows}, {hd}) bf16",
                     max_abs_err=err, ms=ms, ms_wall=ms_w, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    return entry


def check_flash_attention(dev, g):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_attention_with_lse, mha_reference

    b, h, d = 1, 16, 64
    entry = None
    for s in (128, 520, 1024):
        q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        o_r, lse_r = mha_reference(q, k, v, causal=True, return_lse=True)
        err, lerr = _hold_forward(f"kernel flash_attention b={b} h={h} "
                                  f"s={s} d={d} causal bf16", o, o_r, lse,
                                  lse_r)
        ms, ms_w = time_ms(
            lambda: flash_attention_with_lse(q, k, v, causal=True))
        plain, plain_w = time_ms(
            lambda: mha_reference(q, k, v, causal=True, return_lse=True),
            iters=10)
        lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        pairs = b * h * s * (s + 1) / 2          # causal (q, k) pairs
        flops = 4.0 * pairs * d
        nbytes = 4 * b * h * s * d * 2 + b * h * s * 4
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        log(f"  time s={s}, device ms (wall ms per call): kernel "
            f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
            f"SDPA {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
        entry = dict(name="flash_attention",
                     shape=f"b={b} h={h} s={s} d={d} causal bf16",
                     max_abs_err=max(err, lerr), ms=ms, ms_wall=ms_w,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib)
    return entry


def _kv_int8(kc, vc):
    """An int8 cache from a float one, each row against its own scale:
    ``(k codes, v codes, {k_scale, v_scale})``."""
    from apex_tpu_torch.serving import quantize_kv_rows

    kq, ks = quantize_kv_rows(kc)
    vq, vs = quantize_kv_rows(vc)
    return kq, vq, dict(k_scale=ks, v_scale=vs)


def _kv_library(kc, vc, kw):
    """The library yardstick's cache: the float cache, or the int8 one
    dequantized to bf16 beforehand (the dequantization not timed)."""
    from apex_tpu_torch.ops import dequantize_kv

    if not kw:
        return kc, vc
    return (dequantize_kv(kc, kw["k_scale"]).bfloat16(),
            dequantize_kv(vc, kw["v_scale"]).bfloat16())


def _decode_time(label, q, kc, vc, bt, sl, kw, int8):
    """Row 14's device and wall ms at one case, beside its plain version,
    SDPA over the pages gathered (and dequantized) beforehand (neither
    timed: the aim) and its bound: ``(ms, wall, plain, library, bound,
    bound_by)``."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_decode, paged_attention_reference

    b, h, d = q.shape
    mp, bs = bt.shape[1], kc.shape[2]
    lens = sl.tolist()
    ms, ms_w = time_ms(lambda: flash_decode(q, kc, vc, bt, sl, **kw),
                       iters=100)
    plain, plain_w = time_ms(
        lambda: paged_attention_reference(q, kc, vc, bt, sl, **kw))
    kl, vl = _kv_library(kc, vc, kw)
    kg = kl[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    vg = vl[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    mask = (torch.arange(mp * bs, device=q.device)[None, :]
            < sl[:, None].clamp(min=1))[:, None, None, :]
    lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kg, vg, attn_mask=mask), iters=100)
    del kg, vg, kl, vl
    keys = sum(lens)
    row_bytes = h * d * kc.element_size() + (h * 4 if int8 else 0)
    nbytes = keys * row_bytes * 2 + 2 * b * h * d * q.element_size() \
        + sum(-(-n // bs) for n in lens) * 4 + b * 4
    flops = 4.0 * keys * h * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    log(f"  time {label}, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), SDPA on "
        f"gathered pages {lib:.5f} ({lib_w:.5f}; the aim), bound "
        f"{b_ms:.5f} ({b_by}); kernel / SDPA {ms / lib:.3f}, kernel / bound "
        f"{ms / b_ms:.2f}")
    return ms, ms_w, plain, lib, b_ms, b_by


def check_flash_decode(dev, g, int8: bool = False):
    """Row 14 at the serve's decode shape (b=8, 3,364 keys), bf16 q
    against a bf16 cache, or with ``int8`` against an int8 cache with
    per-row scales (the int8 branch, counted as ``flash_decode_int8``),
    where fp32 q over int8 and over a bf16 cache (kv_dtype int8 and bf16
    at O0) are held too; then ``DECODE_CASES`` (the long-context user's
    decode, head dim 128) from a generator of their own.  Each case is
    held element by element (``decode_excess`` within ``DECODE_ATOL``)
    and to ``DECODE_TOL``, with its seq_len-0 row exactly 0 and a second
    call bitwise equal, and timed beside SDPA on gathered pages and the
    bound.  Returns the serve case's entry, the others under
    ``shapes``."""
    from apex_tpu_torch.ops import flash_decode, paged_attention_reference

    name = "flash_decode_int8" if int8 else "flash_decode"
    tag = "int8 cache" if int8 else "bf16"
    b, h, d, bs, mp, nb = 8, 16, 64, 16, 64, 512
    kc = torch.randn(nb, h, bs, d, generator=g, device=dev).bfloat16()
    vc = torch.randn(nb, h, bs, d, generator=g, device=dev).bfloat16()
    q = torch.randn(b, h, d, generator=g, device=dev).bfloat16()
    # row 0 inactive, row 1 straddles a page, row 2 fills every page
    lens = [0, 16 * 20 + 7, mp * bs, 1, 700, 733, 64, 515]
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = torch.zeros(b, mp, dtype=torch.int32, device=dev)
    nxt = 0
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        bt[i, :pages] = perm[nxt:nxt + pages].int()
        nxt += pages
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {}
    if int8:
        kfl, vfl = kc, vc
        kc, vc, kw = _kv_int8(kc, vc)

    def hold(q, kc, vc, bt, sl, kw):
        out = flash_decode(q, kc, vc, bt, sl, **kw)
        again = flash_decode(q, kc, vc, bt, sl, **kw)
        torch.cuda.synchronize()
        ref = paged_attention_reference(q, kc, vc, bt, sl, **kw)
        dead = sl == 0
        err, excess = max_err(out, ref), decode_excess(out, ref)
        zero = bool((out[dead] == 0).all()) and bool(dead.any())
        same = torch.equal(out, again)
        ok = err <= DECODE_TOL and excess <= DECODE_ATOL and zero and same
        return out, err, rel_err(out, ref), excess, zero, same, ok

    def held(err, excess):
        return (f"max_abs_err={err:.3e} (tol {DECODE_TOL}), past one ulp "
                f"{excess:.3e} (tol {DECODE_ATOL})")

    out, err, rel, excess, zero, same, ok = hold(q, kc, vc, bt, sl, kw)
    extra = ""
    if int8:
        # fp32 q (O0) over the int8 cache and over the bf16 one
        q32 = q.float()
        for what, kk, vv, kws in (("int8", kc, vc, kw),
                                  ("bf16", kfl, vfl, {})):
            _, e32, _, x32, _, _, ok32 = hold(q32, kk, vv, bt, sl, kws)
            ok = ok and ok32
            extra += f"; fp32 q over the {what} cache {held(e32, x32)}"
    log(f"kernel {name} b={b} h={h} d={d} bs={bs} pages={mp} {tag} "
        f"seq_lens={lens}: {held(err, excess)} max_rel_err={rel:.3e} "
        f"seq_len-0 row exactly 0: {zero}, a second call bitwise equal: "
        f"{same}{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees")
    ms, ms_w, plain, lib, b_ms, b_by = _decode_time(
        f"b={b} h={h} d={d} (the serve's tick)", q, kc, vc, bt, sl, kw, int8)
    entry = dict(name=name,
                 shape=f"b={b} h={h} d={d} bs={bs} pages={mp} {tag}",
                 max_abs_err=err, ms=ms, ms_wall=ms_w, plain_ms=plain,
                 bound_ms=b_ms, bound_by=b_by, library_ms=lib, shapes=[])
    del out, kc, vc, q
    free_memory()
    gc_ = torch.Generator(device=dev)
    gc_.manual_seed(12 + int8)
    for label, h, d, bs, mp, lens, timed in DECODE_CASES:
        kc, vc, bt, sl = _paged_case(dev, gc_, lens, h, d, bs, mp,
                                     sum(-(-n // bs) for n in lens) + 1)
        kc, vc, kw = _kv_int8(kc, vc) if int8 else (kc, vc, {})
        q = torch.randn(len(lens), h, d, generator=gc_,
                        device=dev).bfloat16()
        out, err, rel, excess, zero, same, ok = hold(q, kc, vc, bt, sl, kw)
        log(f"kernel {name} {label} b={len(lens)} h={h} d={d} bs={bs} "
            f"pages={mp} {tag} seq_lens={lens}: {held(err, excess)} "
            f"max_rel_err={rel:.3e} seq_len-0 row exactly 0: {zero}, a "
            f"second call bitwise equal: {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} kernel disagrees ({label})")
        if timed is not None:            # the case's rows without the dead one
            n = len(timed)
            q, bt, sl = q[:n].contiguous(), bt[:n].contiguous(), sl[:n]
        ms, ms_w, plain, lib, b_ms, b_by = _decode_time(
            f"{label} b={len(sl)} h={h} d={d} seq_lens={sl.tolist()}", q, kc,
            vc, bt, sl, kw, int8)
        entry["shapes"].append(dict(
            name=name, shape=f"{label}: b={len(sl)} h={h} d={d} bs={bs} "
                             f"pages={mp} {tag} seq_lens={sl.tolist()}",
            max_abs_err=err, ms=ms, ms_wall=ms_w, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del out, kc, vc, q
        free_memory()
    return entry


def _paged_case(dev, g, lens, h, d, bs, mp, nb):
    """A bf16 cache of ``nb`` random pages and a block table giving each
    row of ``lens`` its own pages (dump-page padding past them)."""
    kc = torch.randn(nb, h, bs, d, generator=g, device=dev).bfloat16()
    vc = torch.randn(nb, h, bs, d, generator=g, device=dev).bfloat16()
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = torch.zeros(len(lens), mp, dtype=torch.int32, device=dev)
    nxt = 0
    for i, n in enumerate(lens):
        pages = -(-min(n, mp * bs) // bs)
        bt[i, :pages] = perm[nxt:nxt + pages].int()
        nxt += pages
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return kc, vc, bt, sl


def multi_library(q, kc, vc, bt, sl, kw):
    """Row 15's library yardstick: SDPA over the pages gathered (and
    dequantized) beforehand (not timed), one boolean mask row per query
    row; returns the call."""
    import torch.nn.functional as F

    b, t, h, d = q.shape
    mp, bs = bt.shape[1], kc.shape[2]
    kl, vl = _kv_library(kc, vc, kw)
    kg = kl[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    vg = vl[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    qp = (sl.long()[:, None] - t
          + torch.arange(t, device=q.device)[None, :]).clamp(min=0)
    mask = (torch.arange(mp * bs, device=q.device)[None, None, :]
            <= qp[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)


def check_flash_decode_multi(dev, g, int8: bool = False):
    """Row 15 at the serve_fast legs' shapes, bf16: the verify step
    (b=8, t=3: K=2 draft tokens plus one) and the chunk steps (b=1, t=32
    the chunked leg's chunk, t=16 the warm-tail rung); with ``int8``
    the same against an int8 cache (the int8 branch, counted as
    ``flash_decode_multi_int8``).  Each case has an
    inactive row, a row with seq_len < t (front padding at negative
    positions), a page-straddling row and a full row; those rows must
    give exactly 0 where nothing is attended, nothing may be NaN, and at
    t=1 the kernel must agree with the row-14 kernel.  Every case, and the
    timed chunk cases, is held element by element (``decode_excess``
    within ``DECODE_ATOL``) beside ``DECODE_TOL``, as row 14 is: a merge
    that drops a split passes ``DECODE_TOL`` alone.  Returns the verify
    entry with the chunk shapes under ``chunk``."""
    from apex_tpu_torch.ops import (flash_decode, flash_decode_multi,
                                    paged_attention_multi_reference)

    name = "flash_decode_multi_int8" if int8 else "flash_decode_multi"
    tag = "int8 cache" if int8 else "bf16"
    h, d, bs, mp, nb = 16, 64, 16, 64, 512
    cases = (  # (b, t, seq_lens checked, seq_lens timed)
        (8, 3, [0, 2, 16 * 20 + 7, mp * bs, 700, 733, 64, 515], None),
        (1, 32, [0, 27, 16 * 20 + 7, mp * bs], [390]),
        (1, 16, [0, 11, 16 * 20 + 7, mp * bs], [703]),
    )

    def case(lens):
        kc, vc, bt, sl = _paged_case(dev, g, lens, h, d, bs, mp, nb)
        kc, vc, kw = _kv_int8(kc, vc) if int8 else (kc, vc, {})
        return kc, vc, bt, sl, kw

    entries = []
    for b, t, lens, timed in cases:
        kc, vc, bt, sl, kw = case(lens)
        q = torch.randn(len(lens), t, h, d, generator=g,
                        device=dev).bfloat16()
        out = flash_decode_multi(q, kc, vc, bt, sl, **kw)
        torch.cuda.synchronize()
        ref = paged_attention_multi_reference(q, kc, vc, bt, sl, **kw)
        err, excess = max_err(out, ref), decode_excess(out, ref)
        qpos = torch.tensor(lens, device=dev)[:, None] - t \
            + torch.arange(t, device=dev)[None, :]
        dead = qpos < 0                  # nothing to attend: exactly 0
        zero = bool((out[dead] == 0).all()) and int(dead.sum()) >= t + 1
        finite = bool(torch.isfinite(out).all())
        ok = err <= DECODE_TOL and excess <= DECODE_ATOL and zero and finite
        msg = ""
        if t == 3:
            # t = 1 through the multi kernel against the row-14 kernel
            one = flash_decode_multi(q[:, :1], kc, vc, bt, sl, **kw)[:, 0]
            dec = flash_decode(q[:, 0].contiguous(), kc, vc, bt, sl, **kw)
            torch.cuda.synchronize()
            e1, x1 = max_err(one, dec), decode_excess(one, dec)
            ok = ok and e1 <= DECODE_TOL and x1 <= DECODE_ATOL
            msg = (f" t=1 vs flash_decode {e1:.3e} (tol {DECODE_TOL}), past "
                   f"one ulp {x1:.3e} (tol {DECODE_ATOL})")
        log(f"kernel {name} b={len(lens)} t={t} h={h} d={d} "
            f"bs={bs} pages={mp} {tag} seq_lens={lens}: max_abs_err="
            f"{err:.3e} (tol {DECODE_TOL}), past one ulp {excess:.3e} (tol "
            f"{DECODE_ATOL}) max_rel_err={rel_err(out, ref):.3e} "
            f"{int(dead.sum())} rows with nothing to attend exactly 0: "
            f"{zero}, finite: {finite}{msg} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} kernel disagrees at t={t}")
        if timed is not None:            # the main path's batch of one
            lens = timed
            kc, vc, bt, sl, kw = case(lens)
            q = torch.randn(b, t, h, d, generator=g, device=dev).bfloat16()
            out = flash_decode_multi(q, kc, vc, bt, sl, **kw)
            torch.cuda.synchronize()
            ref = paged_attention_multi_reference(q, kc, vc, bt, sl, **kw)
            e2, x2 = max_err(out, ref), decode_excess(out, ref)
            log(f"  timed case seq_lens={lens}: max_abs_err={e2:.3e}, past "
                f"one ulp {x2:.3e}")
            if not (e2 <= DECODE_TOL and x2 <= DECODE_ATOL):
                raise AssertionError(f"{name} kernel disagrees at t={t} "
                                     f"seq_lens={lens}")
            err = max(err, e2)
        ms, ms_w = time_ms(
            lambda: flash_decode_multi(q, kc, vc, bt, sl, **kw), iters=100)
        plain, plain_w = time_ms(
            lambda: paged_attention_multi_reference(q, kc, vc, bt, sl, **kw))
        lib, lib_w = time_ms(multi_library(q, kc, vc, bt, sl, kw),
                             iters=100)
        keys = sum(min(n, mp * bs) for n in lens)
        attended = sum(max(0, min(n - t + r + 1, mp * bs))
                       for n in lens for r in range(t))
        row_bytes = h * d * kc.element_size() + (h * 4 if int8 else 0)
        nbytes = keys * row_bytes * 2 + 2 * b * t * h * d * 2 \
            + sum(-(-min(n, mp * bs) // bs) for n in lens) * 4 + b * 4
        flops = 4.0 * attended * h * d
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        log(f"  time b={b} t={t} seq_lens={lens}, device ms (wall ms per "
            f"call): kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f} "
            f"({plain_w:.5f}), SDPA on gathered pages {lib:.5f} "
            f"({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
        entries.append(dict(
            name=name,
            shape=f"b={b} t={t} h={h} d={d} bs={bs} pages={mp} {tag} "
                  f"seq_lens={lens}",
            max_abs_err=err, ms=ms, ms_wall=ms_w, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    # the long-context user's verify, held only: 16,384 positions over 64
    # splits, where a merge that drops one moves elements by about
    # DECODE_TOL / 2 (from a generator of its own, so later checks keep
    # their inputs)
    gl = torch.Generator(device=dev)
    gl.manual_seed(14 + int8)
    b, t, lens = MULTI_LONG
    kc, vc, bt, sl = _paged_case(dev, gl, lens, h, d, bs, 1024,
                                 sum(-(-n // bs) for n in lens) + 1)
    kc, vc, kw = _kv_int8(kc, vc) if int8 else (kc, vc, {})
    q = torch.randn(b, t, h, d, generator=gl, device=dev).bfloat16()
    out = flash_decode_multi(q, kc, vc, bt, sl, **kw)
    one = flash_decode_multi(q[:, :1], kc, vc, bt, sl, **kw)[:, 0]
    dec = flash_decode(q[:, 0].contiguous(), kc, vc, bt, sl, **kw)
    torch.cuda.synchronize()
    ref = paged_attention_multi_reference(q, kc, vc, bt, sl, **kw)
    err, excess = max_err(out, ref), decode_excess(out, ref)
    x1 = decode_excess(one, dec)
    ok = err <= DECODE_TOL and excess <= DECODE_ATOL and x1 <= DECODE_ATOL \
        and bool(torch.isfinite(out).all())
    log(f"kernel {name} long verify b={b} t={t} h={h} d={d} bs={bs} "
        f"pages=1024 {tag} seq_lens={lens}: max_abs_err={err:.3e} (tol "
        f"{DECODE_TOL}), past one ulp {excess:.3e} (tol {DECODE_ATOL}); t=1 "
        f"vs flash_decode past one ulp {x1:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees at the long verify")
    del kc, vc, q, out, ref
    free_memory()
    entry = dict(entries[0])
    entry["chunk"] = entries[1:]
    return entry


# --- phase 2, the Q8 serve's shapes -----------------------------------

def ulps(got, ref, mant_bits: int = 7, slack: float = 0.0) -> float:
    """max over elements of (|got - ref| - ``slack``) in units of one ulp
    (``mant_bits`` explicit mantissa bits: bf16 7) of the larger of |got|
    and |ref|."""
    g, r = got.float(), ref.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp(min=2.0 ** -126)
    ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - mant_bits)
    return float((((g - r).abs() - slack).clamp(min=0.0) / ulp).max())


def ulps_of_ref(got, ref, mant_bits: int = 10,
                floor_rel: float = FP16_ULP_FLOOR) -> float:
    """max over elements of |got - ref| in units of one ulp (``mant_bits``
    explicit mantissa bits: fp16 10) of the element's own |ref|, taken
    no smaller than ``floor_rel`` of the largest |ref|."""
    g, r = got.float(), ref.float()
    floor = max(floor_rel * float(r.abs().max()), 2.0 ** -126)
    ulp = torch.pow(2.0, torch.floor(torch.log2(r.abs().clamp(min=floor)))
                    - mant_bits)
    return float(((g - r).abs() / ulp).max())


def _qmm_case(dev, g, m, k, n, x_dtype, zero_col=None):
    from apex_tpu_torch.ops import quantize_weight

    w = 0.02 * torch.randn(k, n, generator=g, device=dev)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    wq, sc = quantize_weight(w.to(torch.bfloat16))
    x = torch.randn(m, k, generator=g, device=dev).to(x_dtype)
    return x, wq, sc


def _qmm_hold(x, wq, sc, out_dtype, label):
    """One kernel call against the plain version: fp32 out within
    ``QMM_REL_TOL`` of max |plain|, a bf16/fp16 out within one ulp."""
    from apex_tpu_torch.ops import quant_matmul, quant_matmul_reference

    out = quant_matmul(x, wq, sc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    ref = quant_matmul_reference(x, wq, sc, out_dtype=out_dtype)
    err = max_err(out, ref)
    if out_dtype == torch.float32:
        dev_ = rel_err(out, ref)
        ok, what = dev_ <= QMM_REL_TOL, f"max_rel_err={dev_:.3e} (tol " \
            f"{QMM_REL_TOL})"
    else:
        slack = QMM_REL_TOL * float(ref.float().abs().max())
        u = ulps(out, ref, 7 if out_dtype == torch.bfloat16 else 10, slack)
        ok, what = u <= QMM_ULPS, f"max {u:.3f} ulps beyond {slack:.2e} " \
            f"(tol {QMM_ULPS})"
    m, k = x.shape
    log(f"kernel quant_matmul M={m} K={k} N={wq.shape[1]} {x.dtype} x -> "
        f"{out_dtype}: max_abs_err={err:.3e} {what} {'ok' if ok else 'FAIL'}"
        f" ({label})")
    if not ok:
        raise AssertionError(f"quant_matmul kernel disagrees at M={m} "
                             f"K={k} N={wq.shape[1]}")
    return out, err


def check_quant_matmul(dev, g):
    """Rows 16 (GEMV, M <= 8) and 17 (tiled, M > 8): JAX's self_check
    shapes (fp32: the FMA kernels), shapes whose N and K are no multiple
    of the vector width and an x and wq misaligned by one element (the
    element-load paths), bf16 and fp16 x (the tensor-core kernels) into
    fp32 out, an all-zero weight column (exactly 0 out, both kernels and
    every route), the GEMV at every M from 1 to 8 at the qkv shape; then
    the Q8 serve's shapes in bf16, each held and timed: the GEMV at M = 8
    for the four linears of a decode tick, the tiled kernel at the
    700-token prefill's M = 704 for the four linears and at the verify's
    M = 24 and the chunk's M = 32 for qkv.  Returns the two entries,
    every timed shape under ``shapes``."""
    from apex_tpu_torch.ops import (dequantize_weight, launch_counts,
                                    quant_matmul, quant_matmul_reference,
                                    reset_launch_counts)

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    reset_launch_counts()
    for m, k, n in ((1, 96, 160), (4, 128, 384), (8, 256, 256),
                    (160, 128, 256), (3, 77, 100), (100, 77, 100)):
        x, wq, sc = _qmm_case(dev, g, m, k, n, f32)
        _qmm_hold(x, wq, sc, f32, "self_check / odd shape")
    # bf16 and fp16 x (the tensor-core kernels), into fp32 out; (100, 77,
    # 100), (5, 77, 100) and N = 200 take the element loads
    for m, k, n, dt in ((5, 1024, 1024, bf16), (33, 1024, 1024, bf16),
                        (100, 77, 100, bf16), (40, 96, 160, f16),
                        (64, 256, 256, f16), (5, 77, 100, bf16),
                        (7, 1000, 200, f16)):
        x, wq, sc = _qmm_case(dev, g, m, k, n, dt)
        _qmm_hold(x, wq, sc, f32, f"{dt} x, fp32 out")
    # x and wq one element off their 16-byte alignment: the GEMV's
    # element loads
    x, wq, sc = _qmm_case(dev, g, 6, 1024, 256, bf16)
    xo = torch.empty(x.numel() + 1, dtype=bf16, device=dev)[1:].view_as(x)
    wo = torch.empty(wq.numel() + 1, dtype=wq.dtype,
                     device=dev)[1:].view_as(wq)
    xo.copy_(x)
    wo.copy_(wq)
    _qmm_hold(xo, wo, sc, bf16, "x and wq misaligned")
    for m, dt in ((8, f32), (64, f32), (64, bf16), (8, bf16), (3, f16)):
        x, wq, sc = _qmm_case(dev, g, m, 256, 160, dt, zero_col=37)
        out, _ = _qmm_hold(x, wq, sc, dt, "an all-zero column")
        if not bool((out[:, 37] == 0).all()):
            raise AssertionError(f"M={m}: the all-zero column is not 0")
    # the GEMV at every M of a decode tick, at the qkv shape
    for m in range(1, 9):
        x, wq, sc = _qmm_case(dev, g, m, 1024, 3072, bf16)
        _qmm_hold(x, wq, sc, bf16, "the GEMV's M, qkv")
    x, wq, sc = _qmm_case(dev, g, 8, 1024, 3072, f16)
    _qmm_hold(x, wq, sc, f16, "the GEMV's M, qkv")
    c = launch_counts()
    if c["quant_gemv"] != 20 or c["quant_tiled"] != 8:
        raise AssertionError(f"dispatch by M: launches {c}")
    linears = {"qkv": (1024, 3072), "dense": (1024, 1024),
               "fc1": (1024, 4096), "fc2": (4096, 1024)}
    cases = [("quant_gemv", 8, name, kn) for name, kn in linears.items()] \
        + [("quant_tiled", 704, name, kn) for name, kn in linears.items()] \
        + [("quant_tiled", m, "qkv", linears["qkv"]) for m in (24, 32)]
    entries = {"quant_gemv": [], "quant_tiled": []}
    for kernel, m, name, (k, n) in cases:
        x, wq, sc = _qmm_case(dev, g, m, k, n, bf16)
        _, err = _qmm_hold(x, wq, sc, bf16, f"{name}, the Q8 serve")
        ms, ms_w = time_ms(lambda: quant_matmul(x, wq, sc), iters=100)
        plain, plain_w = time_ms(lambda: quant_matmul_reference(x, wq, sc))
        # library yardstick: what O5 runs, bf16 x against the bf16
        # weight (here the dequantized one)
        wd = dequantize_weight(wq, sc, bf16)
        lib, lib_w = time_ms(lambda: torch.matmul(x, wd), iters=100)
        nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k, BF16_FLOPS)
        aim = "; aim: at or below torch.matmul" if kernel == "quant_gemv" \
            else ""
        log(f"  time {name} M={m} K={k} N={n}, device ms (wall ms per "
            f"call): kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f} "
            f"({plain_w:.5f}), torch.matmul on the bf16 weight {lib:.5f} "
            f"({lib_w:.5f}{aim}), bound {b_ms:.5f} ({b_by}); kernel / "
            f"torch.matmul {ms / lib:.3f}")
        entries[kernel].append(dict(
            name=kernel, shape=f"{name} M={m} K={k} N={n} bf16 x, int8 w",
            max_abs_err=err, ms=ms, ms_wall=ms_w, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del wd
    out = []
    for kernel, es in entries.items():
        e = dict(es[0])
        e["max_abs_err"] = max(x["max_abs_err"] for x in es)
        e["shapes"] = es[1:]
        out.append(e)
    return tuple(out)


# --- phase 2, the train step's shapes ----------------------------------

def ln_bwd_paths_equal(x, gamma, dy, mean, rstd):
    """Row 2's vector path (``x`` as given, 16-byte aligned) against its
    element path (the same values through a view one element off 16-byte
    alignment): whether dx, dgamma and dbeta are equal bit for bit."""
    from apex_tpu_torch.ops import layer_norm_backward

    vec = layer_norm_backward(x, gamma, dy, mean, rstd)
    elem = layer_norm_backward(misaligned(x), gamma, dy, mean, rstd)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(vec, elem))


def ln_wgrad_f64(x, gamma32, dy, mean, rstd) -> float:
    """Row 2's fp32-gamma dgamma and dbeta against float64 sums over the
    rows of the plain version's own terms (dy times its fp32 xhat, and
    dy): the larger of the two max errors, each over its largest value
    (``LN_WGRAD_F64_RTOL``)."""
    from apex_tpu_torch.ops import layer_norm_backward

    _, dg, db = layer_norm_backward(x, gamma32, dy, mean, rstd)
    torch.cuda.synchronize()
    xhat = (x.float() - mean.unsqueeze(-1)) * rstd.unsqueeze(-1)
    dyd = dy.double()
    rg = (dyd * xhat.double()).sum(0)
    rb = dyd.sum(0)
    return max(float((a.double() - r).abs().max() / r.abs().max())
               for a, r in ((dg, rg), (db, rb)))


def check_layer_norm_bwd(dev, g, dtype=torch.bfloat16):
    """LayerNorm forward and backward at the train step's shape with
    gamma/beta in x's dtype: bf16 (O5) or fp16 (O2), the tolerances
    scaled to the dtype's ulp; the backward's vector path bit for bit its
    element path's (``ln_bwd_paths_equal``) with gamma in x's dtype and in
    fp32, and fp32 gamma's dgamma/dbeta within ``LN_WGRAD_F64_RTOL`` of
    float64 sums (``ln_wgrad_f64``).  Returns ``(forward, backward)``
    entries."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm_backward, layer_norm_with_stats
    from apex_tpu_torch.ops.layer_norm import (layer_norm_backward_reference,
                                               layer_norm_stats_reference)

    rows, hd = 8192, 1024              # batch 8 x seq 1024, hidden 1024
    fp16 = dtype == torch.float16
    tag = {torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    x = torch.randn(rows, hd, generator=g, device=dev).to(dtype)
    dy = torch.randn(rows, hd, generator=g, device=dev).to(dtype)
    gamma = (1 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(dtype)
    beta = (0.1 * torch.randn(hd, generator=g, device=dev)).to(dtype)
    # the forward as the train step launches it: gamma/beta in x's dtype
    # (the <T, T> instantiation; the serve's checks run fp32 gamma)
    y, mean, rstd = layer_norm_with_stats(x, gamma, beta, 1e-5)
    torch.cuda.synchronize()
    yr, mr, rr = layer_norm_stats_reference(x, gamma, beta, 1e-5)
    err = max_err(y, yr)
    stat_err = max(max_err(mean, mr), max_err(rstd, rr))
    if fp16:
        u = ulps_of_ref(y, yr)
        ok, what = u <= 1.0, f"max {u:.3f} fp16 ulps of the reference (tol 1)"
    else:
        ok, what = err <= LN_TOL, f"tol {LN_TOL}"
    same = ln_paths_equal(x, gamma, beta)
    ok = ok and stat_err <= 1e-4 and same
    log(f"kernel layer_norm rows={rows} hidden={hd} {tag} x, {tag} "
        f"gamma/beta: max_abs_err={err:.3e} ({what}) "
        f"max_rel_err={rel_err(y, yr):.3e} "
        f"stats_err={stat_err:.3e} (tol 1e-4), vector path y/mean/rstd "
        f"bitwise the element path's: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("layer_norm kernel disagrees at the train "
                             "shape")
    ms, ms_w = time_ms(lambda: layer_norm_with_stats(x, gamma, beta, 1e-5))
    plain, plain_w = time_ms(
        lambda: layer_norm_stats_reference(x, gamma, beta, 1e-5))
    lib, lib_w = time_ms(lambda: F.layer_norm(x, (hd,), gamma, beta, 1e-5))
    b_ms, b_by = bound_ms(2 * rows * hd * 2 + 2 * hd * 2 + 2 * rows * 4,
                          8.0 * rows * hd, FP32_FLOPS)
    log(f"  time rows={rows} (forward), device ms (wall ms per call): "
        f"kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
        f"F.layer_norm {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
    fwd = dict(name="layer_norm", shape=f"({rows}, {hd}) {tag}, {tag} "
               f"gamma/beta", max_abs_err=err, ms=ms, ms_wall=ms_w,
               plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    # backward: the kernel from the kernel's statistics, the plain
    # version from the plain forward's
    dx, dg, db = layer_norm_backward(x, gamma, dy, mean, rstd)
    torch.cuda.synchronize()
    rx, rg, rb = layer_norm_backward_reference(x, gamma, dy, mr, rr)
    err = max_err(dx, rx)
    wrel = max(rel_err(dg, rg), rel_err(db, rb))
    if fp16:
        ux, uw = ulps_of_ref(dx, rx), max(ulps_of_ref(dg, rg),
                                          ulps_of_ref(db, rb))
        ok = ux <= 1.0 and uw <= 1.0
        what = (f"max {ux:.3f} fp16 ulps of the reference (tol 1)",
                f"max {uw:.3f} fp16 ulps (tol 1)")
    else:
        ok = err <= LN_BWD_TOL and wrel <= LN_WGRAD_RTOL
        what = (f"tol {LN_BWD_TOL}", f"tol {LN_WGRAD_RTOL}")
    ok = ok and dg.dtype == db.dtype == dtype
    log(f"kernel layer_norm_bwd rows={rows} hidden={hd} {tag} "
        f"x/dy/gamma: dx max_abs_err={err:.3e} ({what[0]}) "
        f"max_rel_err={rel_err(dx, rx):.3e}; dgamma/dbeta max_rel_err="
        f"{wrel:.3e} ({what[1]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("layer_norm_bwd kernel disagrees")
    # the vector path against the element path, gamma in x's dtype and in
    # fp32; fp32 gamma's dgamma/dbeta against float64 sums
    same = ln_bwd_paths_equal(x, gamma, dy, mean, rstd)
    g32 = gamma.float()
    same32 = ln_bwd_paths_equal(x, g32, dy, mean, rstd)
    f64 = ln_wgrad_f64(x, g32, dy, mean, rstd)
    ok = same and same32 and f64 <= LN_WGRAD_F64_RTOL
    log(f"kernel layer_norm_bwd rows={rows} hidden={hd} {tag}: vector path "
        f"dx/dgamma/dbeta bitwise the element path's with {tag} gamma: "
        f"{same}, with fp32 gamma: {same32}; fp32-gamma dgamma/dbeta against "
        f"float64 sums {f64:.3e} of their largest (tol {LN_WGRAD_F64_RTOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("layer_norm_bwd paths or wgrad sums disagree")
    ms, ms_w = time_ms(lambda: layer_norm_backward(x, gamma, dy, mean, rstd))
    plain, plain_w = time_ms(
        lambda: layer_norm_backward_reference(x, gamma, dy, mean, rstd))
    # library: aten's LayerNorm backward on its own forward's saved
    # statistics, and F.layer_norm forward + backward under autograd
    _, m2, r2 = torch.ops.aten.native_layer_norm(x, [hd], gamma, beta, 1e-5)
    lib, lib_w = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [hd], m2, r2, gamma, beta, [True, True, True]))
    xr = x.clone().requires_grad_(True)

    def fwd_bwd():
        F.layer_norm(xr, (hd,), gamma, beta, 1e-5).backward(dy)

    ag, ag_w = time_ms(fwd_bwd)
    nbytes = 3 * rows * hd * 2 + 2 * rows * 4 + 3 * hd * 2
    flops = 12.0 * rows * hd
    b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOPS)
    log(f"  time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), aten "
        f"native_layer_norm_backward {lib:.5f} ({lib_w:.5f}), F.layer_norm "
        f"forward+backward under autograd {ag:.5f} ({ag_w:.5f}), bound "
        f"{b_ms:.5f} ({b_by})")
    return fwd, dict(name="layer_norm_bwd", shape=f"({rows}, {hd}) {tag}, "
                     f"{tag} gamma", max_abs_err=err, ms=ms, ms_wall=ms_w,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, library_autograd_ms=ag)


def check_flash_attention_e(dev, g):
    """The E forward and backward at the train step's shape against their
    plain versions (:func:`_e_case`), the backward also against autograd
    of the plain forward; returns the two kernel entries."""
    from apex_tpu_torch.ops import flash_attention_e_reference

    b, s, h, d = 8, 1024, 16, 64
    qkv, o4, lse, do, dqkv, counts, err, berr = _e_case(dev, g, b, s, h, d)
    want = {"flash_attention_e": 1, "flash_attention_e_bwd": 1}
    if counts != want:
        raise AssertionError(f"E launches {counts} != {want}")
    if dqkv.shape != qkv.shape:
        raise AssertionError(f"dqkv {tuple(dqkv.shape)} != qkv's shape")
    # against autograd of the forward's plain version (fp32 throughout,
    # delta from the unrounded o): relative Frobenius error per part
    qr = qkv.clone().requires_grad_(True)
    out_r = flash_attention_e_reference(qr, causal=True)
    dqkv_r, = torch.autograd.grad(out_r, qr, do.reshape(b, s, h * d))
    del out_r
    frob = [float((a.float() - r.float()).norm() / r.float().norm())
            for a, r in zip(dqkv.split(d, dim=-1), dqkv_r.split(d, dim=-1))]
    ok = all(x <= DQKV_FROB_RTOL for x in frob)
    log(f"kernel flash_attention_e_bwd vs autograd of mha_reference: "
        f"||err|| / ||ref|| per part "
        + ", ".join(f"d{n} {x:.3e}" for n, x in zip("qkv", frob))
        + f" (tol {DQKV_FROB_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_e_bwd kernel disagrees with "
                             "autograd of the plain forward")
    del qr, dqkv_r, dqkv
    shape = f"b={b} s={s} h={h} d={d} causal bf16"
    fwd, bwd = _e_times(shape, qkv, o4, lse, do)
    return (dict(fwd, name="flash_attention_e", shape=shape,
                 max_abs_err=err),
            dict(bwd, name="flash_attention_e_bwd", shape=shape,
                 max_abs_err=berr))


def check_fused_adam(dev, g, dtype=torch.bfloat16):
    """The Adam sweep with grads and the model copy in ``dtype``: bf16
    (O5) or fp16 (O2), the copy's tolerance one ulp of the dtype."""
    from apex_tpu_torch.ops import adam_pipeline, adam_pipeline_reference

    n = 1 << 26                       # 67M elements, one flat group
    tag = {torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    grad = (0.01 * torch.randn(n, generator=g, device=dev)).to(dtype)
    p0 = torch.randn(n, generator=g, device=dev)
    m0 = 0.001 * torch.randn(n, generator=g, device=dev)
    v0 = 1e-6 * torch.rand(n, generator=g, device=dev)
    hyp = dict(grad_scale=1.0, lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
               weight_decay=0.01, bias_correction1=1 - 0.9 ** 3,
               bias_correction2=1 - 0.999 ** 3, adam_w_mode=True)

    def fresh():
        return (p0.clone(), m0.clone(), v0.clone(),
                torch.empty(n, dtype=dtype, device=dev))

    kp, km, kv, kl = fresh()
    adam_pipeline(grad, kp, km, kv, kl, keep=True, **hyp)
    torch.cuda.synchronize()
    rp, rm, rv, rl = fresh()
    adam_pipeline_reference(grad, rp, rm, rv, rl, keep=True, **hyp)
    err = max(max_err(kp, rp), max_err(km, rm), max_err(kv, rv))
    # relative to the value, or to fp16's least normal for its subnormals
    floor = 1e-30 if dtype == torch.bfloat16 else 2.0 ** -14
    lowp_rel = float(((kl.float() - rl.float()).abs()
                      / rl.float().abs().clamp(min=floor)).max())
    ok = err <= ADAM_TOL and lowp_rel <= ulp and \
        not torch.equal(kp, p0)
    kp, km, kv, kl = fresh()
    adam_pipeline(grad, kp, km, kv, kl, keep=False, **hyp)
    torch.cuda.synchronize()
    skip_ok = torch.equal(kp, p0) and torch.equal(km, m0) and \
        torch.equal(kv, v0) and torch.equal(kl, p0.to(dtype))
    log(f"kernel fused_adam_pipeline n={n} {tag} g, fp32 p/m/v, {tag} "
        f"copy: keep=1 max_abs_err={err:.3e} (tol {ADAM_TOL}), {tag} copy "
        f"max_rel_err={lowp_rel:.3e} (tol {ulp:.4g}); keep=0 leaves p/m/v "
        f"bitwise unchanged and the copy = {tag}(p): {skip_ok} "
        f"{'ok' if ok and skip_ok else 'FAIL'}")
    if not (ok and skip_ok):
        raise AssertionError("fused_adam_pipeline kernel disagrees")
    ms, ms_w = time_ms(lambda: adam_pipeline(grad, kp, km, kv, kl,
                                             keep=True, **hyp))
    plain, plain_w = time_ms(lambda: adam_pipeline_reference(
        grad, rp, rm, rv, rl, keep=True, **hyp), iters=10)
    # library: PyTorch's fused AdamW on fp32 grads; it reads 4-byte
    # grads and writes no low-precision copy
    g32 = grad.float()
    step = torch.zeros((), device=dev)
    lib, lib_w = time_ms(lambda: torch._fused_adamw_(
        [rp], [g32], [rm], [rv], [], [step], lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False))
    b_ms, b_by = bound_ms(28.0 * n, 20.0 * n, FP32_FLOPS)
    log(f"  time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
        f"torch._fused_adamw_ (fp32 grads, no {tag} copy) {lib:.5f} "
        f"({lib_w:.5f}), bound {b_ms:.5f} ({b_by}); GPT-345M's 355M "
        f"elements would take {ms * 355e6 / n:.3f} ms at this rate")
    return dict(name="fused_adam_pipeline", shape=f"n={n} {tag} g, fp32 "
                f"p/m/v, {tag} copy", max_abs_err=err, ms=ms, ms_wall=ms_w,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)


# --- phase 2, the O2 train step's shapes -------------------------------

def check_scaled_softmax(dev, g):
    """The causal softmax forward and the softmax backward at the O2
    step's fp32 (b*h, s, s) scores, their fp16 builds, and other row
    lengths (each register width, lanes left idle, the element path off
    the vector width and the looped variant); the forward's 16-byte path
    bitwise against its element path, taken through a misaligned view (at
    the other lengths also at scale 0.1, whose products round).  Returns
    the two kernel entries."""
    from apex_tpu_torch.ops import (causal_softmax, causal_softmax_reference,
                                    softmax_backward,
                                    softmax_backward_reference)

    scale = 0.125                      # head_dim 64 ** -0.5
    # other row lengths first: sk <= 128, 200 (16-byte loads with lanes
    # left idle), 98 (off the vector width: the element path), 300 (two
    # 256-row JAX blocks) and 1500 (the looped variant), fp32 and bf16;
    # 200 and 98 draw from a generator of their own, so the checks after
    # this one keep their inputs
    gs = torch.Generator(device=dev)
    gs.manual_seed(19)
    for shape in ((4, 64, 64), (3, 300, 300), (2, 1500, 1500),
                  (3, 200, 200), (3, 98, 98)):
        gen = g if shape[-1] in (64, 300, 1500) else gs
        for dtype, tol in ((torch.float32, SOFTMAX_TOL),
                           (torch.bfloat16, 2.0 ** -8)):
            x = (3 * torch.randn(*shape, generator=gen, device=dev)).to(dtype)
            dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
            y = causal_softmax(x, scale)
            dx = softmax_backward(y, dy, scale)
            torch.cuda.synchronize()
            err = max_err(y, causal_softmax_reference(x, scale))
            berr = rel_err(dx, softmax_backward_reference(y, dy, scale))
            zero = bool((y.triu(1) == 0).all())
            xm = misaligned(x)
            same = all(torch.equal(causal_softmax(xm, sc), causal_softmax(
                x, sc)) for sc in (scale, 0.1))
            ok = err <= tol and berr <= max(tol, SOFTMAX_BWD_RTOL) and zero \
                and same
            log(f"kernel scaled_softmax {tuple(shape)} {dtype}: forward "
                f"max_abs_err={err:.3e}, backward max_rel_err={berr:.3e} "
                f"(tol {tol:.3g}), upper triangle exactly 0: {zero}, forward "
                f"equal through a misaligned view (the element path; at "
                f"scales {scale} and 0.1): {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"scaled_softmax kernels disagree at "
                                     f"{shape} {dtype}")
    b3, s = 8 * 16, 1024               # batch 8 x 16 heads, seq 1024
    entries = {}
    for dtype, tol in ((torch.float16, SOFTMAX_FP16_TOL),
                       (torch.float32, SOFTMAX_TOL)):
        tag = {torch.float32: "fp32", torch.float16: "fp16"}[dtype]
        x = (3 * torch.randn(b3, s, s, generator=g, device=dev)).to(dtype)
        dy = torch.randn(b3, s, s, generator=g, device=dev).to(dtype)
        y = causal_softmax(x, scale)
        torch.cuda.synchronize()
        yr = causal_softmax_reference(x, scale)
        err = max_err(y, yr)
        zero = bool((y.triu(1) == 0).all())
        del yr
        dx = softmax_backward(y, dy, scale)
        torch.cuda.synchronize()
        dxr = softmax_backward_reference(y, dy, scale)
        berr = max_err(dx, dxr)
        brel = berr / max(float(dxr.float().abs().max()), 1e-30)
        del dxr, dx
        btol = tol if dtype == torch.float16 else SOFTMAX_BWD_RTOL
        # the forward's element path through a view one element off
        # alignment
        same = bool(torch.equal(causal_softmax(misaligned(x), scale), y))
        ok = err <= tol and zero and brel <= btol and same
        log(f"kernel scaled_softmax_causal_fwd ({b3}, {s}, {s}) {tag}, "
            f"scale {scale}: max_abs_err={err:.3e} (tol {tol:.3g}), upper "
            f"triangle exactly 0: {zero}; scaled_softmax_bwd max_abs_err="
            f"{berr:.3e}, over max |dx| {brel:.3e} (tol {btol:.3g}); the "
            f"forward bitwise its element path: {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"scaled_softmax kernels disagree at the "
                                 f"O2 step's shape, {tag}")
        free_memory()
        # times: the forward against torch.softmax of the input masked
        # beforehand (-inf above the diagonal; the masking not timed)
        ms, ms_w = time_ms(lambda: causal_softmax(x, scale))
        plain, plain_w = time_ms(lambda: causal_softmax_reference(x, scale),
                                 iters=10)
        keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        xm = (x.float() * scale).masked_fill(~keep, float("-inf")).to(dtype)
        lib, lib_w = time_ms(lambda: torch.softmax(xm, -1))
        del xm
        esz = x.element_size()
        kept = b3 * s * (s + 1) // 2
        # read the kept entries once, write every entry once
        b_ms, b_by = bound_ms(kept * esz + b3 * s * s * esz, 5.0 * kept,
                              FP32_FLOPS)
        full_ms = 2 * x.numel() * esz / HBM_BYTES_S * 1e3
        log(f"  forward time, device ms (wall ms per call): kernel "
            f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
            f"torch.softmax on the pre-masked input {lib:.5f} "
            f"({lib_w:.5f}), bound {b_ms:.5f} ({b_by}; {full_ms:.5f} if "
            f"the upper triangle were read)")
        fwd = dict(name="scaled_softmax_causal_fwd",
                   shape=f"({b3}, {s}, {s}) {tag}", max_abs_err=err, ms=ms,
                   ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib)
        ms, ms_w = time_ms(lambda: softmax_backward(y, dy, scale))
        plain, plain_w = time_ms(
            lambda: softmax_backward_reference(y, dy, scale), iters=10)
        lib, lib_w = time_ms(lambda: torch._softmax_backward_data(
            dy, y, -1, dtype))
        b_ms, b_by = bound_ms(3 * x.numel() * esz, 4.0 * x.numel(),
                              FP32_FLOPS)
        log(f"  backward time, device ms (wall ms per call): kernel "
            f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
            f"torch._softmax_backward_data {lib:.5f} ({lib_w:.5f}), bound "
            f"{b_ms:.5f} ({b_by})")
        bwd = dict(name="scaled_softmax_bwd",
                   shape=f"({b3}, {s}, {s}) {tag}", max_abs_err=berr, ms=ms,
                   ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib)
        entries[tag] = (fwd, bwd)
        del x, dy, y
        free_memory()
    fwd, bwd = entries["fp32"]         # the path's build
    fwd["fp16"], bwd["fp16"] = entries["fp16"]
    return fwd, bwd


def check_norm_finite(dev, g):
    """The norm/finite sweep over one flat fp16 buffer of GPT-345M's
    size at inv = 2^-16, with an inf and a NaN planted at its first,
    middle and last element."""
    from apex_tpu_torch.ops import grad_norm_finite, grad_norm_finite_reference
    from apex_tpu_torch.ops.fused_pipeline import _launch_norm_finite

    n, inv = 354_871_296, 2.0 ** -16   # the O2 step's one fp16 group
    buf = (0.01 / inv * torch.randn(n, generator=g, device=dev)).half()
    norm, fin = grad_norm_finite([buf], inv)
    torch.cuda.synchronize()
    rnorm, rfin = grad_norm_finite_reference([buf], inv)
    rel = abs(float(norm) - float(rnorm)) / float(rnorm)
    again = grad_norm_finite([buf], inv)[0]
    same = bool(torch.equal(norm, again))
    ok = bool(fin) and bool(rfin) and rel <= NORM_RTOL and same
    planted = []
    for bad in (float("inf"), float("nan")):
        for i in (0, n // 2, n - 1):
            old = buf[i].clone()
            buf[i] = bad
            f = bool(grad_norm_finite([buf], inv)[1])
            planted.append(f)
            buf[i] = old
    ok = ok and not any(planted)
    log(f"kernel norm_finite n={n} fp16, inv 2^-16: norm {float(norm):.6f} "
        f"vs plain {float(rnorm):.6f}, relative error {rel:.3e} (tol "
        f"{NORM_RTOL}), finite {bool(fin)}, the same bits again: {same}; "
        f"inf/NaN planted at first/middle/last give finite {planted} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("norm_finite kernel disagrees")
    ms, ms_w = time_ms(lambda: _launch_norm_finite(buf, inv))
    plain, plain_w = time_ms(
        lambda: grad_norm_finite_reference([buf], inv), iters=10)
    lib, lib_w = time_ms(
        lambda: torch.linalg.vector_norm(buf, dtype=torch.float32))
    b_ms, b_by = bound_ms(2.0 * n, 3.0 * n, FP32_FLOPS)
    log(f"  time, device ms (wall ms per call): kernel pair {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
        f"torch.linalg.vector_norm (no finite flag) {lib:.5f} "
        f"({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
    return dict(name="norm_finite", shape=f"n={n} fp16", max_abs_err=abs(
        float(norm) - float(rnorm)), ms=ms, ms_wall=ms_w, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib)


# --- phase 2, the BERT-large train steps' shapes -----------------------

def bert_mask(dev, g, dead_row: bool = False):
    """A (16, 512) padding mask as the BERT phases draw it (the first 4
    rows full, the rest padded from a seeded length in [128, 512]); with
    ``dead_row`` the last row all pad, a batch row that attends
    nothing."""
    from apex_tpu_torch.testing.standalone_bert import padded_mask

    b, s = BERT_BATCH
    m = padded_mask(b, s, g, device=dev)
    if dead_row:
        m[-1] = 0
    return m


def bert_large_params() -> int:
    """BERT-large's parameter count, the train recipes' one flat group
    (the model built on the meta device: no memory)."""
    from apex_tpu_torch.testing.standalone_bert import MODELS, BertModel

    geo = MODELS["bertlarge"]
    net = BertModel(geo["vocab_size"], geo["hidden_size"],
                    geo["num_layers"], geo["num_heads"], geo["seq"],
                    num_tokentypes=0, device="meta")
    return sum(p.numel() for p in net.parameters())


def check_grad_routing(dev, g):
    """Gradient routing on the card: ``layer_norm`` with a grad-requiring
    input records a graph and its backward is the row-2 kernel, equal to
    the plain backward; ``flash_attention`` with grad-requiring q, k, v
    records a graph, launches row 6 then row 8 once each, and its
    gradients equal the plain backward's on the forward's (o, lse) and
    the same do; without grad it launches row 6 alone.  Returns no
    entry."""
    from apex_tpu_torch.ops import (flash_attention_backward_reference,
                                    flash_attention_with_lse, launch_counts,
                                    layer_norm, reset_launch_counts)
    from apex_tpu_torch.ops.layer_norm import (layer_norm_backward_reference,
                                               layer_norm_stats_reference)

    rows, hd = 512, 1024
    x = torch.randn(rows, hd, generator=g, device=dev).bfloat16()
    dy = torch.randn(rows, hd, generator=g, device=dev).bfloat16()
    gamma = (1 + 0.1 * torch.randn(hd, generator=g, device=dev))
    beta = 0.1 * torch.randn(hd, generator=g, device=dev)
    xg, gg, bg = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
    reset_launch_counts()
    y = layer_norm(xg, gg, bg)
    graph = y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    _, mr, rr = layer_norm_stats_reference(x, gamma, beta)
    rx, rg, rb = layer_norm_backward_reference(x, gamma, dy, mr, rr)
    err = max_err(xg.grad, rx)
    wrel = max(rel_err(gg.grad, rg), rel_err(bg.grad, rb))
    ok = graph and counts == {"layer_norm": 1, "layer_norm_bwd": 1} and \
        err <= LN_BWD_TOL and wrel <= LN_WGRAD_RTOL
    q, k, v = (torch.randn(1, 16, 128, 64, generator=g, device=dev)
               .bfloat16() for _ in range(3))
    # do from a generator of its own: g's later draws stay as they were
    gd = torch.Generator(device=dev)
    gd.manual_seed(9)
    do = torch.randn(1, 16, 128, 64, generator=gd, device=dev).bfloat16()
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launch_counts()
    o, lse = flash_attention_with_lse(*qkv, causal=True)
    lse = lse.detach()
    fgraph = o.grad_fn is not None
    fwd_counts = {n: c for n, c in launch_counts().items() if c}
    o.backward(do)
    torch.cuda.synchronize()
    bwd_counts = {n: c for n, c in launch_counts().items() if c}
    want = flash_attention_backward_reference(q, k, v, o.detach(), lse, do,
                                              causal=True)
    ferr = max(max_err(t.grad, w) for t, w in zip(qkv, want))
    fexcess = max(grad_excess(t.grad, w) for t, w in zip(qkv, want))
    fok = fgraph and fwd_counts == {"flash_attention": 1} and \
        bwd_counts == {"flash_attention": 1, "flash_attention_bwd": 1} and \
        fexcess <= DQKV_ATOL
    reset_launch_counts()
    with torch.no_grad():
        flash_attention_with_lse(*qkv, causal=True)
    ran = {n: c for n, c in launch_counts().items() if c} == \
        {"flash_attention": 1}
    ok = ok and fok and ran
    log(f"grad routing: layer_norm on a grad-requiring bf16 x and fp32 "
        f"gamma/beta records a graph: {graph}, launches {counts}, dx "
        f"max_abs_err={err:.3e} (tol {LN_BWD_TOL}), dgamma/dbeta "
        f"max_rel_err={wrel:.3e} (tol {LN_WGRAD_RTOL}) against the plain "
        f"backward; flash_attention on grad-requiring q, k, v records a "
        f"graph: {fgraph}, launches {fwd_counts} then {bwd_counts}, "
        f"dq/dk/dv max_abs_err={ferr:.3e}, max(|err| - "
        f"{DQKV_ULP_RTOL:.4g}|ref|)={fexcess:.3e} (tol {DQKV_ATOL}) against "
        f"the plain backward on the same (o, lse, do); under "
        f"no_grad launches row 6 alone: {ran} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("grad routing wrong on the card")


def check_masked_softmax(dev, g):
    """Row 5, the padding-mask softmax, at the BERT O2 step's (16, 16,
    512, 512) scores with its extended mask (every padded query row fully
    masked, one batch row all pad), fp16 and fp32 input; the row-4
    backward on the fp32 probabilities, as the O2 step runs it.  Fully
    masked rows must be exactly 1/sk, live rows exactly 0 on masked keys,
    nothing NaN.  The row-4 backward is timed beside
    ``torch._softmax_backward_data``.  Returns the row-5 entry (fp32, with
    the fp16 one) and row 4's at this shape (a sub-entry of
    ``scaled_softmax_bwd``)."""
    from apex_tpu_torch.ops import (masked_softmax, masked_softmax_reference,
                                    softmax_backward,
                                    softmax_backward_reference)
    from apex_tpu_torch.testing.standalone_bert import \
        bert_extended_attention_mask

    (b, s), h, scale = BERT_BATCH, 16, 0.125
    mask = bert_extended_attention_mask(bert_mask(dev, g, dead_row=True))
    dead = mask[:, 0].all(-1)[:, None, :, None].expand(b, h, s, s)
    gone = mask.expand(b, h, s, s) & ~dead     # masked keys of live rows
    entries = {}
    for dtype, tol in ((torch.float16, SOFTMAX_FP16_TOL),
                       (torch.float32, SOFTMAX_TOL)):
        tag = {torch.float32: "fp32", torch.float16: "fp16"}[dtype]
        x = (3 * torch.randn(b, h, s, s, generator=g, device=dev)).to(dtype)
        y = masked_softmax(x, mask, scale)
        torch.cuda.synchronize()
        yr = masked_softmax_reference(x, mask, scale)
        err = max_err(y, yr)
        finite = bool(torch.isfinite(y).all())
        uniform = bool((y[dead] == 1.0 / s).all())
        zero = bool((y[gone] == 0).all())
        del yr
        ok = err <= tol and finite and uniform and zero
        what = ""
        if dtype == torch.float32:
            dy = torch.randn(b, h, s, s, generator=g, device=dev)
            dx = softmax_backward(y, dy, scale)
            torch.cuda.synchronize()
            dxr = softmax_backward_reference(y, dy, scale)
            brel = rel_err(dx, dxr)
            babs = max_err(dx, dxr)
            del dxr
            bfin = bool(torch.isfinite(dx).all())
            ok = ok and brel <= SOFTMAX_BWD_RTOL and bfin
            what = (f"; scaled_softmax_bwd on its fp32 y: max_rel_err="
                    f"{brel:.3e} (tol {SOFTMAX_BWD_RTOL}), finite {bfin}")
            del dx
        log(f"kernel scaled_masked_softmax_fwd ({b}, {h}, {s}, {s}) {tag}, "
            f"(b, 1, s, s) mask, {int(dead[:, 0, :, 0].sum())} fully masked "
            f"query rows: max_abs_err={err:.3e} (tol {tol:.3g}), finite "
            f"{finite}, fully masked rows exactly 1/sk: {uniform}, masked "
            f"keys of live rows exactly 0: {zero}{what} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"scaled_masked_softmax kernel disagrees, "
                                 f"{tag}")
        free_memory()
        ms, ms_w = time_ms(lambda: masked_softmax(x, mask, scale))
        plain, plain_w = time_ms(
            lambda: masked_softmax_reference(x, mask, scale), iters=10)
        # library: torch.softmax of the input filled beforehand (the
        # dtype's least value in place of -1e30; the fill not timed)
        xm = (x.float() * scale).masked_fill(
            mask, torch.finfo(dtype).min).to(dtype)
        lib, lib_w = time_ms(lambda: torch.softmax(xm, -1))
        del xm
        b_ms, b_by = bound_ms(2 * x.numel() * x.element_size() + b * s * s,
                              5.0 * x.numel(), FP32_FLOPS)
        log(f"  time, device ms (wall ms per call): kernel {ms:.5f} "
            f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), torch.softmax "
            f"on the masked_fill'ed input {lib:.5f} ({lib_w:.5f}), bound "
            f"{b_ms:.5f} ({b_by})")
        entries[tag] = dict(
            name="scaled_masked_softmax_fwd", shape=f"({b}, {h}, {s}, {s}) "
            f"{tag}, (b, 1, s, s) mask", max_abs_err=err, ms=ms, ms_wall=ms_w,
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        if dtype == torch.float32:
            # row 4 as the BERT O2 step runs it, on these probabilities
            ms, ms_w = time_ms(lambda: softmax_backward(y, dy, scale))
            plain, plain_w = time_ms(
                lambda: softmax_backward_reference(y, dy, scale), iters=10)
            lib, lib_w = time_ms(lambda: torch._softmax_backward_data(
                dy, y, -1, dtype))
            b_ms, b_by = bound_ms(3 * x.numel() * x.element_size(),
                                  4.0 * x.numel(), FP32_FLOPS)
            log(f"  scaled_softmax_bwd at this shape, device ms (wall ms "
                f"per call): kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f} "
                f"({plain_w:.5f}), torch._softmax_backward_data {lib:.5f} "
                f"({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
            entries["bwd"] = dict(
                name="scaled_softmax_bwd", of=("scaled_softmax_bwd", "bert"),
                shape=f"({b}, {h}, {s}, {s}) fp32, padding-mask "
                f"probabilities", max_abs_err=babs, ms=ms, ms_wall=ms_w,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            del dy
        del x, y
        free_memory()
    entry = entries["fp32"]                   # the path's build
    entry["fp16"] = entries["fp16"]
    return entry, entries["bwd"]


def check_flash_attention_e_kvmask(dev, g):
    """The kv_mask lanes of rows 10 and 12 at the BERT O5 step's shape
    (b=16, s=512, h=16, d=64, not causal, bf16) with its padding mask and
    one all-pad batch row: the forward against its plain version (o = 0
    and lse = -inf on the all-pad row), the backward element by element
    against its plain version and by relative Frobenius error against
    autograd of the plain forward (zero gradients on the all-pad row,
    dk = dv = 0 on every masked key).  Returns the two entries."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention_e_backward,
                                    flash_attention_e_reference,
                                    flash_attention_e_with_lse,
                                    mha_reference)
    from apex_tpu_torch.ops.flash_attention import \
        flash_attention_e_backward_reference

    (b, s), h, d = BERT_BATCH, 16, 64
    kv = bert_mask(dev, g, dead_row=True).float()
    keep = kv > 0
    qkv = torch.randn(b, s, h, 3 * d, generator=g, device=dev).bfloat16()
    do = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    o, lse = flash_attention_e_with_lse(qkv, kv_mask=kv)
    torch.cuda.synchronize()
    o_r, lse_r = mha_reference(q, k, v, return_lse=True, kv_mask=kv)
    o_r = o_r.transpose(1, 2).reshape(b, s, h * d)
    live = torch.isfinite(lse_r)
    err = max_err(o, o_r)
    lerr = max_err(lse[live], lse_r[live])
    dead_ok = bool((o[-1] == 0).all()) and \
        bool(torch.isneginf(lse[-1]).all()) and \
        bool(torch.equal(torch.isfinite(lse), live))
    ok = err <= ATTN_TOL and lerr <= LSE_TOL and dead_ok and \
        bool(torch.isfinite(o).all())
    log(f"kernel flash_attention_e_kvmask b={b} s={s} h={h} d={d} bf16, "
        f"kv_mask with {int(kv.sum())} of {b * s} keys live (row {b - 1} "
        f"all pad): max_abs_err={err:.3e} (tol {ATTN_TOL}) lse_err="
        f"{lerr:.3e} on live rows (tol {LSE_TOL}); all-pad row o = 0 and "
        f"lse = -inf, no NaN: {dead_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_e kv_mask lane disagrees")
    o4 = o.view(b, s, h, d)
    dqkv = flash_attention_e_backward(qkv, o4, lse, do, kv_mask=kv)
    torch.cuda.synchronize()
    dqkv_p = flash_attention_e_backward_reference(qkv, o4, lse, do,
                                                  kv_mask=kv)
    berr = max_err(dqkv, dqkv_p)
    parts = []
    for i, part in enumerate("qkv"):
        kp, rp = (t[..., i * d:(i + 1) * d].float() for t in (dqkv, dqkv_p))
        diff = (kp - rp).abs()
        parts.append((part, float((diff - DQKV_ULP_RTOL * rp.abs()).max())))
    zeros = bool((dqkv[-1] == 0).all()) and \
        bool((dqkv[..., d:][~keep] == 0).all()) and \
        bool(torch.isfinite(dqkv).all())
    ok = all(x <= DQKV_ATOL for _, x in parts) and zeros
    del dqkv_p
    qr = qkv.clone().requires_grad_(True)
    out_r = flash_attention_e_reference(qr, kv_mask=kv)
    do_flat = do.reshape(b, s, h * d)
    dqkv_r, = torch.autograd.grad(out_r, qr, do_flat, retain_graph=True)
    frob = []
    for i, part in enumerate("qkv"):
        kp, rp = (t[..., i * d:(i + 1) * d].float() for t in (dqkv, dqkv_r))
        frob.append((part, float((kp - rp).norm() / rp.norm())))
    ok = ok and all(x <= DQKV_FROB_RTOL for _, x in frob)
    log(f"kernel flash_attention_e_bwd_kvmask vs its plain version: "
        f"max_abs_err={berr:.3e}, per part max(|err| - "
        f"{DQKV_ULP_RTOL:.4g}|ref|) (tol {DQKV_ATOL}) "
        + ", ".join(f"d{n} {x:.3e}" for n, x in parts)
        + f"; vs autograd of the plain forward ||err|| / ||ref|| "
        + ", ".join(f"d{n} {x:.3e}" for n, x in frob)
        + f" (tol {DQKV_FROB_RTOL}); all-pad row and masked keys' dk, dv "
        f"exactly 0, no NaN: {zeros} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_e_bwd kv_mask lane disagrees")
    # the work this mask needs: each row's s queries against its live keys
    pairs = float(h * s * kv.sum())
    ms, ms_w = time_ms(lambda: flash_attention_e_with_lse(qkv, kv_mask=kv))
    plain, plain_w = time_ms(lambda: mha_reference(
        q, k, v, return_lse=True, kv_mask=kv), iters=10)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    am = keep[:, None, None, :]
    lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=am))
    nbytes = b * s * h * 3 * d * 2 + b * s * h * d * 2 + b * h * s * 4 \
        + b * s * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * d * pairs, BF16_FLOPS)
    log(f"  forward time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), SDPA with a "
        f"boolean (b, 1, 1, s) attn_mask {lib:.5f} ({lib_w:.5f}), bound "
        f"{b_ms:.5f} ({b_by}; {pairs:.4g} live (q, k) pairs)")
    fwd = dict(name="flash_attention_e_kvmask",
               shape=f"b={b} s={s} h={h} d={d} kv_mask bf16",
               max_abs_err=max(err, lerr), ms=ms, ms_wall=ms_w,
               plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    ms, ms_w = time_ms(lambda: flash_attention_e_backward(
        qkv, o4, lse, do, kv_mask=kv))
    plain, plain_w = time_ms(lambda: flash_attention_e_backward_reference(
        qkv, o4, lse, do, kv_mask=kv), iters=10)
    del out_r, dqkv_r
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (qc, kc, vc))
    out_s = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
    do_s = do.transpose(1, 2).contiguous()
    lib, lib_w = time_ms(lambda: torch.autograd.grad(
        out_s, (qs, ks, vs), do_s, retain_graph=True))
    nbytes = 2 * b * s * h * 3 * d * 2 + 2 * b * s * h * d * 2 \
        + b * h * s * 4 + b * s * 4
    b_ms, b_by = bound_ms(nbytes, 10.0 * d * pairs, BF16_FLOPS)
    log(f"  backward time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), SDPA backward "
        f"{lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
    bwd = dict(name="flash_attention_e_bwd_kvmask",
               shape=f"b={b} s={s} h={h} d={d} kv_mask bf16",
               max_abs_err=berr, ms=ms, ms_wall=ms_w, plain_ms=plain,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    return fwd, bwd


def check_lamb_phase1(dev, g):
    """LAMB phase 1 over one flat buffer of BERT-large's size (bf16 g,
    fp32 p/m/v, the scale a device scalar) in both moment modes, against
    its plain version: u, m and v within ``LAMB_RTOL`` of their largest
    value, p untouched."""
    from apex_tpu_torch.ops import lamb_phase1, lamb_phase1_reference

    n = bert_large_params()
    grad = (0.01 * torch.randn(n, generator=g, device=dev)).bfloat16()
    p0 = torch.randn(n, generator=g, device=dev)
    m0 = 0.001 * torch.randn(n, generator=g, device=dev)
    v0 = 1e-6 * torch.rand(n, generator=g, device=dev)
    gscale = torch.full((), 0.5, device=dev)
    hyp = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
               weight_decay=0.01, bias_correction1=1 - 0.9 ** 3,
               bias_correction2=1 - 0.999 ** 3)
    sums = float(p0.double().sum())
    errs, aerr = {}, 0.0
    for mode in (False, True):         # the path's AdamW mode last
        km, kv = m0.clone(), v0.clone()
        u, _, _ = lamb_phase1(grad, p0, km, kv, grad_scale=gscale,
                              adam_w_mode=mode, **hyp)
        torch.cuda.synchronize()
        rm, rv = m0.clone(), v0.clone()
        ur, _, _ = lamb_phase1_reference(grad, p0, rm, rv, grad_scale=0.5,
                                         adam_w_mode=mode, **hyp)
        errs[mode] = max(rel_err(u, ur), rel_err(km, rm), rel_err(kv, rv))
        aerr = max(aerr, max_err(u, ur), max_err(km, rm), max_err(kv, rv))
        del ur, rm, rv
    err = max(errs.values())
    held = float(p0.double().sum()) == sums
    ok = err <= LAMB_RTOL and held and bool(torch.isfinite(u).all())
    log(f"kernel lamb_phase1 n={n} bf16 g, fp32 p/m/v, device scale: u, m, "
        f"v max error over max |ref| {errs[True]:.3e} (AdamW), "
        f"{errs[False]:.3e} (L2) (tol {LAMB_RTOL}); p untouched: {held} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("lamb_phase1 kernel disagrees")
    del u
    free_memory()
    ms, ms_w = time_ms(lambda: lamb_phase1(grad, p0, km, kv,
                                           grad_scale=gscale, **hyp))
    plain, plain_w = time_ms(lambda: lamb_phase1_reference(
        grad, p0, km, kv, grad_scale=gscale, **hyp), iters=10)
    # g read (2 bytes), p, m, v read (12), m, v, u written (12)
    b_ms, b_by = bound_ms(26.0 * n, 20.0 * n, FP32_FLOPS)
    log(f"  time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), no single "
        f"PyTorch call computes it, bound {b_ms:.5f} ({b_by})")
    return dict(name="lamb_phase1", shape=f"n={n} bf16 g, fp32 p/m/v",
                max_abs_err=aerr, ms=ms, ms_wall=ms_w, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


# --- phase 2, the long-context slice's shapes ---------------------------

def _attn_bound(b, h, s, d, causal, bwd, kv_mask=None):
    """The card's bound on the (b, h, s, d) self-attention forward or
    backward: bf16 operands read once and outputs written once (forward
    q, k, v, o; backward q, k, v, o, do, dq, dk, dv; the fp32 lse; a
    (b, s) fp32 ``kv_mask``), 4 d (forward) or 10 d (backward)
    operations per attended (q, k) pair (with a full ``kv_mask``, each
    row's s queries against its live keys).  Dropout's keep bits are
    hashed in the kernels: no bytes, and the same products."""
    if kv_mask is not None:
        assert not causal
        pairs = float(h * s * kv_mask.sum())
    else:
        pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
    nbytes = (8 if bwd else 4) * b * h * s * d * 2 + b * h * s * 4 \
        + (0 if kv_mask is None else b * s * 4)
    return bound_ms(nbytes, (10.0 if bwd else 4.0) * d * pairs, BF16_FLOPS)


def _hold_forward(label, o, o_r, lse, lse_r):
    """Hold a flash forward against its plain version: o element by
    element (``grad_excess`` within ``DQKV_ATOL``), the fp32 lse within
    ``LSE_TOL`` (a row that attends nothing -inf on both sides); returns
    ``(max |o err|, max |lse err|)``."""
    excess, err = grad_excess(o, o_r), max_err(o, o_r)
    live = torch.isfinite(lse_r)
    lerr = max_err(lse[live], lse_r[live])
    ok = bool(torch.isfinite(o).all()) and excess <= DQKV_ATOL and \
        lerr <= LSE_TOL and torch.equal(torch.isfinite(lse), live)
    log(f"{label}: o max(|err| - {DQKV_ULP_RTOL:.4g}|ref|)={excess:.3e} "
        f"(tol {DQKV_ATOL}), max |err| {err:.3e}; lse_err={lerr:.3e} (tol "
        f"{LSE_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err, lerr


def _hold_backward(label, got, want):
    """Hold (dq, dk, dv) against the plain backward element by element
    (``grad_excess`` within ``DQKV_ATOL``); returns the max abs error."""
    parts = [(n, grad_excess(a, b), max_err(a, b))
             for n, a, b in zip("qkv", got, want)]
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    ok = finite and all(x <= DQKV_ATOL for _, x, _ in parts)
    log(f"kernel {label} vs the backward's plain version: per gradient "
        f"max(|err| - {DQKV_ULP_RTOL:.4g}|ref|) (tol {DQKV_ATOL}), max "
        f"|err|: " + ", ".join(f"d{n} {x:.3e} {e:.3e}" for n, x, e in parts)
        + f"; finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return max(e for _, _, e in parts)


def check_flash_attention_bwd(dev, g):
    """Row 8, the (b, h, s, d) backward, against its plain version on the
    same (q, k, v, o, lse, do): at (1, 16, 1024, 64) causal (also against
    autograd of the plain forward, and timed: the entry), at sq != sk
    (1, 16, 384, 1000) full and causal and (1, 16, 1000, 384) causal, and
    at d = 128, (1, 16, 1024, 128) causal (timed: a sub-entry) and (1,
    16, 384, 1000) causal; row 6's forward at d = 128 (timed: a sub-entry
    of row 6's); then the fp16 instantiations of both (``BWD_FP16_CASES``;
    the forward held by :func:`_hold_forward` and, at sq == sk, timed: a
    sub-entry of row 6's)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention_backward,
                                    flash_attention_backward_reference,
                                    flash_attention_with_lse, mha_reference)

    out = {}
    for n, (b, h, sq, sk, d, causal) in enumerate(BWD_CASES):
        shape = (f"b={b} h={h} sq={sq} sk={sk} d={d} "
                 f"{'causal' if causal else 'full'} bf16")
        q = torch.randn(b, h, sq, d, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, h, sk, d, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        do = torch.randn(b, h, sq, d, generator=g, device=dev).bfloat16()
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_r, lse_r = mha_reference(q, k, v, causal=causal, return_lse=True)
        err, lerr = _hold_forward(f"kernel flash_attention {shape}", o, o_r,
                                  lse, lse_r)
        grads = flash_attention_backward(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal=causal)
        berr = _hold_backward(f"flash_attention_bwd {shape}", grads, want)
        del want
        if n == 0:
            refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out_r = mha_reference(*refs, causal=causal)
            got_r = torch.autograd.grad(out_r, refs, do)
            frob = [float((a.float() - r.float()).norm() / r.float().norm())
                    for a, r in zip(grads, got_r)]
            ok = all(x <= DQKV_FROB_RTOL for x in frob)
            log(f"kernel flash_attention_bwd vs autograd of mha_reference: "
                f"||err|| / ||ref|| " + ", ".join(
                    f"d{n} {x:.3e}" for n, x in zip("qkv", frob))
                + f" (tol {DQKV_FROB_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash_attention_bwd disagrees with "
                                     "autograd of the plain forward")
            del out_r, got_r, refs
        if sq != sk:
            continue
        # timed: the backward at d = 64 and 128, the forward at d = 128
        ms, ms_w = time_ms(lambda: flash_attention_backward(
            q, k, v, o, lse, do, causal=True))
        plain, plain_w = time_ms(lambda: flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=True), iters=10)
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        out_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lib, lib_w = time_ms(lambda: torch.autograd.grad(
            out_s, (qs, ks, vs), do, retain_graph=True))
        del out_s
        b_ms, b_by = _attn_bound(b, h, sq, d, True, bwd=True)
        log(f"  backward time {shape}, device ms (wall ms per call): kernel "
            f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
            f"SDPA backward {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} "
            f"({b_by})")
        out[f"bwd{d}"] = dict(
            name="flash_attention_bwd", shape=shape, max_abs_err=berr,
            ms=ms, ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib)
        if d == 128:
            ms, ms_w = time_ms(lambda: flash_attention_with_lse(
                q, k, v, causal=True))
            plain, plain_w = time_ms(lambda: mha_reference(
                q, k, v, causal=True, return_lse=True), iters=10)
            lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            b_ms, b_by = _attn_bound(b, h, sq, d, True, bwd=False)
            log(f"  forward time {shape}, device ms (wall ms per call): "
                f"kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f} "
                f"({plain_w:.5f}), SDPA {lib:.5f} ({lib_w:.5f}), bound "
                f"{b_ms:.5f} ({b_by})")
            out["fwd128"] = dict(
                name="flash_attention", shape=shape,
                max_abs_err=max(err, lerr), ms=ms, ms_wall=ms_w,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)
        free_memory()
    fp16, fwd16 = {}, {}
    for b, h, sq, sk, d, causal in BWD_FP16_CASES:
        shape = (f"b={b} h={h} sq={sq} sk={sk} d={d} "
                 f"{'causal' if causal else 'full'} fp16")
        q, do = (torch.randn(b, h, sq, d, generator=g, device=dev).half()
                 for _ in range(2))
        k, v = (torch.randn(b, h, sk, d, generator=g, device=dev).half()
                for _ in range(2))
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        grads = flash_attention_backward(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        o_r, lse_r = mha_reference(q, k, v, causal=causal, return_lse=True)
        ferr, flerr = _hold_forward(f"kernel flash_attention {shape}", o, o_r,
                                    lse, lse_r)
        del o_r, lse_r
        berr = _hold_backward(f"flash_attention_bwd {shape}", grads,
                              flash_attention_backward_reference(
                                  q, k, v, o, lse, do, causal=causal))
        if sq == sk:
            # the fp16 forward, timed beside the bf16 one of the same shape
            ms, ms_w = time_ms(lambda: flash_attention_with_lse(
                q, k, v, causal=causal))
            plain, _ = time_ms(lambda: mha_reference(
                q, k, v, causal=causal, return_lse=True), iters=10)
            lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            b_ms, b_by = _attn_bound(b, h, sq, d, causal, bwd=False)
            log(f"  forward time {shape}, device ms (wall ms per call): "
                f"kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f}, SDPA "
                f"{lib:.5f}, bound {b_ms:.5f} ({b_by})")
            fwd16[d] = dict(shape=shape, max_abs_err=max(ferr, flerr), ms=ms,
                            ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib)
            # timed beside the bf16 case of the same shape
            ms, ms_w = time_ms(lambda: flash_attention_backward(
                q, k, v, o, lse, do, causal=causal))
            plain, _ = time_ms(lambda: flash_attention_backward_reference(
                q, k, v, o, lse, do, causal=causal), iters=10)
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            out_s = F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=causal)
            lib, _ = time_ms(lambda: torch.autograd.grad(
                out_s, (qs, ks, vs), do, retain_graph=True))
            del out_s
            b_ms, b_by = _attn_bound(b, h, sq, d, causal, bwd=True)
            log(f"  backward time {shape}, device ms (wall ms per call): "
                f"kernel {ms:.5f} ({ms_w:.5f}), plain {plain:.5f}, SDPA "
                f"backward {lib:.5f}, bound {b_ms:.5f} ({b_by})")
            fp16[d] = dict(shape=shape, max_abs_err=berr, ms=ms,
                           ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib)
        free_memory()
    entry = out["bwd64"]
    entry["d128"] = out["bwd128"]
    entry["fp16"] = dict(fp16[64], d128=fp16[128])
    return (entry, dict(out["fwd128"], of=("flash_attention", "d128")),
            dict(fwd16[64], d128=fwd16[128], of=("flash_attention", "fp16")))


def _e_case(dev, g, b, s, h, d, causal=True, kv_mask=None, drop=None):
    """One E forward and backward against their plain versions (with the
    ``kv_mask`` and the dropout ``drop``, ``dict(dropout_rate=,
    dropout_seed=)``, when given), launch counts reset just before the
    two launches; returns ``(qkv, o4, lse, do, dqkv, counts, err,
    berr)``."""
    from apex_tpu_torch.ops import (e_mode, flash_attention_e_backward,
                                    flash_attention_e_with_lse,
                                    launch_counts, mha_reference, rand_keep,
                                    reset_launch_counts)
    from apex_tpu_torch.ops.flash_attention import \
        flash_attention_e_backward_reference

    drop = drop or {}
    qkv = torch.randn(b, s, h, 3 * d, generator=g, device=dev).bfloat16()
    do = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    reset_launch_counts()
    o, lse = flash_attention_e_with_lse(qkv, causal=causal, kv_mask=kv_mask,
                                        **drop)
    o4 = o.view(b, s, h, d)
    dqkv = flash_attention_e_backward(qkv, o4, lse, do, causal=causal,
                                      kv_mask=kv_mask, **drop)
    torch.cuda.synchronize()
    counts = {n: c for n, c in launch_counts().items() if c}
    keep = {}
    if drop:
        keep = dict(dropout_rate=drop["dropout_rate"], dropout_keep=rand_keep(
            b, h, s, s, drop["dropout_seed"], drop["dropout_rate"],
            e_mode(s, h, d, drop=True), device=dev))
    o_r, lse_r = mha_reference(q, k, v, causal=causal, return_lse=True,
                               kv_mask=kv_mask, **keep)
    del keep
    o_r = o_r.transpose(1, 2).reshape(b, s, h * d)
    shape = (f"b={b} s={s} h={h} d={d} {'causal' if causal else 'full'}"
             f"{' kv_mask' if kv_mask is not None else ''}"
             f"{' dropout %g' % drop['dropout_rate'] if drop else ''} bf16")
    err, lerr = _hold_forward(f"kernel flash_attention_e {shape} (launches "
                              f"{counts})", o, o_r, lse, lse_r)
    del o_r, lse_r
    want = flash_attention_e_backward_reference(qkv, o4, lse, do,
                                                causal=causal,
                                                kv_mask=kv_mask, **drop)
    berr = _hold_backward(f"flash_attention_e_bwd {shape}",
                          dqkv.split(d, dim=-1), want.split(d, dim=-1))
    return qkv, o4, lse, do, dqkv, counts, max(err, lerr), berr


def _e_times(label, qkv, o4, lse, do, causal=True, iters=30, kv_mask=None,
             drop=None):
    """The E forward and backward (with the ``kv_mask`` and the dropout
    ``drop``, as :func:`_e_case` takes them) timed against their plain
    versions (with dropout: the keep mask's hash included), SDPA (a
    boolean (b, 1, 1, s) mask for the kv_mask; ``dropout_p`` at the rate:
    its own Philox mask, the same work on another mask) and the bound:
    two entries."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (e_mode, flash_attention_e_backward,
                                    flash_attention_e_with_lse,
                                    mha_reference, rand_keep)
    from apex_tpu_torch.ops.flash_attention import \
        flash_attention_e_backward_reference

    drop = drop or {}
    b, s, h, d = o4.shape
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))

    def plain_fwd():
        keep = {} if not drop else dict(
            dropout_rate=drop["dropout_rate"], dropout_keep=rand_keep(
                b, h, s, s, drop["dropout_seed"], drop["dropout_rate"],
                e_mode(s, h, d, drop=True), device=qkv.device))
        return mha_reference(q, k, v, causal=causal, return_lse=True,
                             kv_mask=kv_mask, **keep)

    ms, ms_w = time_ms(lambda: flash_attention_e_with_lse(
        qkv, causal=causal, kv_mask=kv_mask, **drop), iters=iters)
    plain, plain_w = time_ms(plain_fwd, iters=5)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    sdpa = dict(is_causal=causal,
                dropout_p=drop.get("dropout_rate", 0.0))
    if kv_mask is not None:
        sdpa["attn_mask"] = (kv_mask > 0)[:, None, None, :]
    lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, **sdpa))
    b_ms, b_by = _attn_bound(b, h, s, d, causal, bwd=False, kv_mask=kv_mask)
    lib_name = "SDPA" + (f" dropout_p={sdpa['dropout_p']:g}"
                         if drop else "")
    log(f"  {label} forward time, device ms (wall ms per call): kernel "
        f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
        f"{lib_name} {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
    fwd = dict(ms=ms, ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib)
    ms, ms_w = time_ms(lambda: flash_attention_e_backward(
        qkv, o4, lse, do, causal=causal, kv_mask=kv_mask, **drop),
        iters=iters)
    plain, plain_w = time_ms(lambda: flash_attention_e_backward_reference(
        qkv, o4, lse, do, causal=causal, kv_mask=kv_mask, **drop), iters=5)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (qc, kc, vc))
    out_s = F.scaled_dot_product_attention(qs, ks, vs, **sdpa)
    do_s = do.transpose(1, 2).contiguous()
    lib, lib_w = time_ms(lambda: torch.autograd.grad(
        out_s, (qs, ks, vs), do_s, retain_graph=True))
    del out_s
    b_ms, b_by = _attn_bound(b, h, s, d, causal, bwd=True, kv_mask=kv_mask)
    log(f"  {label} backward time, device ms (wall ms per call): kernel "
        f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
        f"{lib_name} backward {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} "
        f"({b_by})")
    bwd = dict(ms=ms, ms_wall=ms_w, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib)
    return fwd, bwd


def check_flash_attention_e_long(dev, g):
    """The E kernels at d = 128 (b=2 s=1024 h=8, the single route: rows
    10/12, timed as sub-entries) and past a padded length of 1024 (rows
    11/13, counted under the blocked names): at the long train step's
    (4, 2048, 16, 64) causal (timed: the two entries) and at (1, 2048,
    8, 128); then forward and backward times per (q, k) pair at 8192
    tokens, s = 1024, 2048, 4096, 8192 (b = 8192 / s, h=16, d=64), the
    measure of a cliff past one JAX block.  Returns the entries."""
    from apex_tpu_torch.ops import (e_mode, flash_attention_e_backward,
                                    flash_attention_e_with_lse)

    entries = []
    single = {"flash_attention_e": 1, "flash_attention_e_bwd": 1}
    blocked = {"flash_attention_e_blocked": 1,
               "flash_attention_e_bwd_blocked": 1}
    for n, (b, s, h, d) in enumerate(E_LONG_CASES):
        want = blocked if e_mode(s) == "blocked" else single
        qkv, o4, lse, do, _, counts, err, berr = _e_case(dev, g, b, s, h, d)
        if counts != want:
            raise AssertionError(f"E launches at s={s}: {counts} != {want}")
        shape = f"b={b} s={s} h={h} d={d} causal bf16"
        if n == 0:
            fwd, bwd = _e_times(f"d=128 {shape}", qkv, o4, lse, do)
            entries.append(dict(fwd, name="flash_attention_e", shape=shape,
                                max_abs_err=err,
                                of=("flash_attention_e", "d128")))
            entries.append(dict(bwd, name="flash_attention_e_bwd",
                                shape=shape, max_abs_err=berr,
                                of=("flash_attention_e_bwd", "d128")))
        elif n == 1:
            fwd, bwd = _e_times(f"blocked {shape}", qkv, o4, lse, do)
            entries.append(dict(fwd, name="flash_attention_e_blocked",
                                shape=shape, max_abs_err=err))
            entries.append(dict(bwd, name="flash_attention_e_bwd_blocked",
                                shape=shape, max_abs_err=berr))
        del qkv, o4, lse, do
        free_memory()
    sweep = []
    for s in E_SWEEP_SEQS:
        b, h, d = E_SWEEP_TOKENS // s, 16, 64
        qkv = torch.randn(b, s, h, 3 * d, generator=g, device=dev).bfloat16()
        do = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
        o, lse = flash_attention_e_with_lse(qkv, causal=True)
        o4 = o.view(b, s, h, d)
        fms, _ = time_ms(lambda: flash_attention_e_with_lse(
            qkv, causal=True), iters=10)
        bms, _ = time_ms(lambda: flash_attention_e_backward(
            qkv, o4, lse, do, causal=True), iters=10)
        pairs = b * h * s * (s + 1) / 2
        sweep.append(dict(b=b, s=s, fwd_ms=fms, bwd_ms=bms,
                          fwd_ns_per_kpair=fms * 1e9 / pairs,
                          bwd_ns_per_kpair=bms * 1e9 / pairs))
        log(f"  E causal b={b} s={s} h={h} d={d} ({b * s} tokens, "
            f"{pairs:.4g} pairs, {e_mode(s)} route): forward {fms:.5f} ms, "
            f"backward {bms:.5f} ms; per 1000 (q, k) pairs "
            f"{fms * 1e9 / pairs:.4f} / {bms * 1e9 / pairs:.4f} ns")
        del qkv, do, o, lse, o4
        free_memory()
    for e in entries:
        if e["name"] == "flash_attention_e_blocked":
            e["sweep"] = sweep
    return tuple(entries)


# --- phase 2, the dropout slice's lanes of rows 10-13 -------------------

def _readback_keep(dev, b, s, h, d, seed):
    """The keep mask each dropout kernel drew at (b, s, h, d), read back
    bit for bit through the unmasked, full-attention lane.  q = 0 makes
    every score 0, so each row's p is 1/s over all s keys.  Per window of
    d keys from c0: v (and k) one-hot on it, v[c] = e_(c - c0), zero
    elsewhere, so the forward's o[r, dim] is keep(r, c0 + dim) (1 - rate)^-1
    / s, nonzero exactly where kept; with do all ones the dQ pass's
    dq[r, dim] = scale (keep (1 - rate)^-1 - delta_r) / s, positive
    exactly where kept (delta_r <= d / s (1 - rate)^-1).  Per window of d
    rows from r0, with q = k = v = 0 and do one-hot on it, the dK/dV
    pass's dv[c, dim] is keep(r0 + dim, c) (1 - rate)^-1 / s.  Returns
    the three (b, h, s, s) bool masks."""
    from apex_tpu_torch.ops import (flash_attention_e_backward,
                                    flash_attention_e_with_lse)

    kw = dict(dropout_rate=DROPOUT_RATE, dropout_seed=seed)
    fwd, dq, dkv = (torch.empty((b, h, s, s), dtype=torch.bool, device=dev)
                    for _ in range(3))
    eye = torch.eye(d, device=dev, dtype=torch.bfloat16)[:, None, :]
    qkv = torch.zeros(b, s, h, 3 * d, device=dev, dtype=torch.bfloat16)
    ones = torch.ones(b, s, h, d, device=dev, dtype=torch.bfloat16)
    for c0 in range(0, s, d):
        qkv.zero_()
        qkv[:, c0:c0 + d, :, d:2 * d] = eye
        qkv[:, c0:c0 + d, :, 2 * d:] = eye
        o, lse = flash_attention_e_with_lse(qkv, **kw)
        o4 = o.view(b, s, h, d)
        fwd[..., c0:c0 + d] = (o4 != 0).permute(0, 2, 1, 3)
        grad = flash_attention_e_backward(qkv, o4, lse, ones, **kw)
        dq[..., c0:c0 + d] = (grad[..., :d] > 0).permute(0, 2, 1, 3)
    qkv.zero_()
    o, lse = flash_attention_e_with_lse(qkv, **kw)
    o4 = o.view(b, s, h, d)
    do = torch.zeros_like(ones)
    for r0 in range(0, s, d):
        do.zero_()
        do[:, r0:r0 + d] = eye
        grad = flash_attention_e_backward(qkv, o4, lse, do, **kw)
        dkv[:, :, r0:r0 + d] = (grad[..., 2 * d:] != 0).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    return fwd, dq, dkv


def _hold_keep(dev, b, s, h, d, seed):
    """The kernels' keep masks at (b, s, h, d), read back
    (:func:`_readback_keep`), against ``rand_keep`` bit for bit; the
    pairs whose hash sits exactly on the threshold are counted, and at
    least one must be among them (a compare written > for >= drops them,
    and must fail here)."""
    from apex_tpu_torch.ops import e_mode, rand_keep
    from apex_tpu_torch.ops.flash_attention import (_drop_width, _hash24,
                                                    _threshold)

    mode = e_mode(s, h, d, drop=True)
    want = rand_keep(b, h, s, s, seed, DROPOUT_RATE, mode, device=dev)
    thr, width = _threshold(DROPOUT_RATE), _drop_width(mode, s, s)
    ties = sum(int((_hash24(bi, h, s, s, seed, width, dev) == thr).sum())
               for bi in range(b))
    got = _readback_keep(dev, b, s, h, d, seed)
    wrong = [int((m != want).sum()) for m in got]
    ok = not any(wrong) and ties > 0
    log(f"kernel dropout keep masks read back at b={b} s={s} h={h} d={d} "
        f"({mode} route, seed {seed}, rate {DROPOUT_RATE}): forward, dQ "
        f"and dK/dV passes against rand_keep, pairs that differ {wrong} of "
        f"{want.numel()} ({float(want.float().mean()):.5f} kept; {ties} "
        f"pairs on the threshold) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the kernels' keep masks at s={s} differ from "
                             f"rand_keep (or no pair tests the threshold)")


def check_flash_attention_e_dropout(dev, g):
    """The dropout lanes of rows 10-13 at rate ``DROPOUT_RATE``, each case
    of ``DROPOUT_CASES`` against the plain versions with the same seed
    (o and lse by :func:`_hold_forward`, dqkv by :func:`_hold_backward`)
    and timed; then the keep masks read back bit for bit at
    ``DROPOUT_READBACK``'s single and blocked shapes.  Returns the four
    entries (GPT's step shape for rows 10/12's lane, the long step's for
    rows 11/13's) with the kv_mask, d = 128 and fallback cases as their
    sub-entries."""
    from apex_tpu_torch.ops import e_mode

    entries = []
    for n, (b, s, h, d, causal, masked) in enumerate(DROPOUT_CASES):
        seed = 1000 + n
        drop = dict(dropout_rate=DROPOUT_RATE, dropout_seed=seed)
        kv = bert_mask(dev, g, dead_row=True).float() if masked else None
        qkv, o4, lse, do, dqkv, counts, err, berr = _e_case(
            dev, g, b, s, h, d, causal=causal, kv_mask=kv, drop=drop)
        blocked = "_blocked" if e_mode(s) == "blocked" else ""
        fname = f"flash_attention_e{blocked}_dropout"
        bname = f"flash_attention_e_bwd{blocked}_dropout"
        if counts != {fname: 1, bname: 1}:
            raise AssertionError(f"dropout launches at {(b, s, h, d)}: "
                                 f"{counts}")
        if masked:
            zeros = bool((o4[-1] == 0).all()) and \
                bool((dqkv[-1] == 0).all()) and \
                bool((dqkv[..., d:][kv == 0] == 0).all())
            log(f"  the all-pad row's o and dqkv and the masked keys' dk, dv "
                f"exactly 0: {zeros} {'ok' if zeros else 'FAIL'}")
            if not zeros:
                raise AssertionError("the kv_mask + dropout lane wrote "
                                     "nonzeros where nothing is attended")
        del dqkv
        route = e_mode(s, h, d, drop=True)
        shape = (f"b={b} s={s} h={h} d={d} {'causal' if causal else 'full'}"
                 f"{' kv_mask' if masked else ''} dropout {DROPOUT_RATE} "
                 f"({route} route) bf16")
        fwd, bwd = _e_times(shape, qkv, o4, lse, do, causal=causal,
                            iters=10 if n else 30, kv_mask=kv, drop=drop)
        fwd.update(name=fname, shape=shape, max_abs_err=err)
        bwd.update(name=bname, shape=shape, max_abs_err=berr)
        # rows 10/12's other lanes are sub-entries of GPT's shape
        sub = "kvmask" if masked else "d128" if d == 128 else \
            "fallback" if route == "fallback" else None
        if sub:
            fwd["of"] = ("flash_attention_e_dropout", sub)
            bwd["of"] = ("flash_attention_e_bwd_dropout", sub)
        entries += [fwd, bwd]
        del qkv, o4, lse, do
        free_memory()
    for shape in DROPOUT_READBACK:
        _hold_keep(dev, *shape, seed=DROPOUT_READBACK_SEED)
        free_memory()
    return tuple(entries)


# --- phase 2, the MoE slice's row 18 -----------------------------------

def _route_bytes(x, logits, u, rd) -> float:
    """The bytes row 18 must move for these inputs: the logits (and u)
    read, each x row that some kept choice dispatches read once, every
    output written once."""
    k, t = rd.expert_index.shape
    e, c, h = rd.buf.shape
    tok = torch.arange(t, device=x.device).repeat(k)[rd.keep]
    rows = int(torch.unique(tok).numel())
    return (4.0 * logits.numel() + (4.0 * u.numel() if u is not None else 0)
            + x.element_size() * (rows * h + e * c * h)
            + k * t * (4 + 4 + 4 + 1) + 4)


def _route_hold(label, x, logits, u, kw, got):
    """Row 18's output ``got`` against its plain version on the same
    (x, logits, u): expert_index, slot, keep and buf exactly equal, gates
    within ``MOE_GATE_TOL``, aux within ``MOE_AUX_RTOL``.  A differing
    expert prints the plain version's top-2 probability gap at the first
    such token (a flip needs two probabilities within an ulp).  Returns
    ``(max |gate| error, the plain version's output)``."""
    from apex_tpu_torch.ops import moe_route_dispatch_reference

    ref = moe_route_dispatch_reference(x, logits, u, **kw)
    if not torch.equal(got.expert_index, ref.expert_index):
        t = int((got.expert_index != ref.expert_index).nonzero()[0, 1])
        p = torch.softmax(logits[t].float(), dim=-1).topk(2).values
        raise AssertionError(f"{label}: expert_index differs at token {t} "
                             f"(plain top-2 probability gap "
                             f"{float(p[0] - p[1]):.3e})")
    for name in ("slot", "keep", "buf"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"{label}: {name} differs from the plain "
                                 f"version")
    gerr = max_err(got.gate, ref.gate)
    aerr = abs(float(got.load_balancing_loss)
               / float(ref.load_balancing_loss) - 1.0)
    if gerr > MOE_GATE_TOL or aerr > MOE_AUX_RTOL:
        raise AssertionError(f"{label}: gate error {gerr:.3e} (tol "
                             f"{MOE_GATE_TOL}), aux relative error "
                             f"{aerr:.3e} (tol {MOE_AUX_RTOL})")
    return gerr, ref


def check_moe_routing(dev, g):
    """Row 18 against its plain version at ``MOE_CASES`` (x ~ N(0, 1),
    logits from a 0.02 randn router), one launch at T <= 32, two above.
    Integers and buf exact, each timed (device, wall, plain, bound; no
    single PyTorch call computes it).  Then the gradient path once:
    autograd through ``MoERouteDispatchFunction`` on CUDA tensors against
    the plain version's own gradient."""
    from apex_tpu_torch.ops import (launch_counts, moe_combine,
                                    moe_route_dispatch_reference,
                                    reset_launch_counts)
    from apex_tpu_torch.ops.moe_routing import _fused

    e = MOE_EXPERTS
    entries = []
    reset_launch_counts()
    for label, t, h, ne, cap, k, pol, dt in MOE_CASES:
        x = torch.randn(t, h, generator=g, device=dev)
        router = 0.02 * torch.randn(h, ne, generator=g, device=dev)
        logits = x @ router
        x = x.to(dt)
        u = torch.rand(t, generator=g, device=dev) if pol == "random" \
            else None
        kw = dict(capacity=cap, top_k=k, second_policy=pol)
        got = _fused(x, logits, u, **kw)
        torch.cuda.synchronize()
        gerr, ref = _route_hold(f"moe_route_dispatch {label}", x, logits, u,
                                kw, got)
        dropped = int((~ref.keep).sum())
        ms, ms_w = time_ms(lambda: _fused(x, logits, u, **kw), iters=100)
        plain, plain_w = time_ms(lambda: moe_route_dispatch_reference(
            x, logits, u, **kw))
        b_ms, b_by = bound_ms(_route_bytes(x, logits, u, ref),
                              10.0 * t * ne, FP32_FLOPS)
        log(f"kernel moe_route_dispatch {label}: T={t} H={h} E={ne} "
            f"C={cap} top{k} {pol} {str(dt).replace('torch.', '')} x: "
            f"expert_index, slot, keep, buf exact; gate error {gerr:.3e} "
            f"(tol {MOE_GATE_TOL}); {dropped} of {k * t} choices dropped ok")
        log(f"  time, device ms (wall ms per call): kernel {ms:.5f} "
            f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), no single "
            f"PyTorch call computes it, bound {b_ms:.5f} ({b_by})")
        entries.append(dict(
            name="moe_route_dispatch",
            shape=f"{label}: T={t} H={h} E={ne} C={cap} top{k} {pol} "
                  f"{str(dt).replace('torch.', '')}",
            max_abs_err=gerr, ms=ms, ms_wall=ms_w, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del x, logits, got, ref
    if launch_counts()["moe_route_dispatch"] <= 0:
        raise AssertionError("moe_route_dispatch never launched")
    # the gradient path: the Function's backward on CUDA tensors is the
    # plain version differentiated at the saved inputs
    x = torch.randn(256, 64, generator=g, device=dev)
    logits = torch.randn(256, e, generator=g, device=dev)
    u = torch.rand(256, generator=g, device=dev)
    grads = []
    for route in (_fused, moe_route_dispatch_reference):
        xx, ll = x.clone().requires_grad_(), logits.clone().requires_grad_()
        rd = route(xx, ll, u, capacity=40, top_k=2, second_policy="random")
        y = moe_combine(rd.buf * 2.0, rd.expert_index, rd.slot, rd.keep,
                        rd.gate)
        ((y ** 2).sum() + 0.1 * rd.load_balancing_loss).backward()
        grads.append((xx.grad, ll.grad))
    gx, gl = max_err(grads[0][0], grads[1][0]), max_err(grads[0][1],
                                                        grads[1][1])
    ok = gx <= MOE_GRAD_TOL and gl <= MOE_GRAD_TOL and \
        float(grads[0][1].abs().max()) > 0
    log(f"kernel moe_route_dispatch gradient (T=256 H=64 top2 random, "
        f"autograd on CUDA tensors): x {gx:.3e}, logits {gl:.3e} against "
        f"the plain version's (tol {MOE_GRAD_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("moe_route_dispatch gradient disagrees")
    e0 = dict(entries[0])
    e0["max_abs_err"] = max(x["max_abs_err"] for x in entries)
    e0["shapes"] = entries[1:]
    return e0


# --- phase 2, the ResNet slice's optimizer kernels ----------------------

def resnet50_leaves():
    """(name, shape, model dtype under O5) of ResNet-50's 161 parameters,
    from the port's module on the ``meta`` device: 55 bf16 (the convs and
    fc), 106 fp32 (the batch norms)."""
    from apex_tpu_torch.amp import get_policy
    from apex_tpu_torch.amp.cast import cast_dtype
    from apex_tpu_torch.models.resnet import ResNet50

    o5 = get_policy("O5")
    return [(n, tuple(p.shape), cast_dtype(n, p, o5))
            for n, p in ResNet50(device="meta").named_parameters()]


def _leaf_buffers(dev, g, leaves, states: int):
    """Seeded (grad, master, state...) a leaf: the grad in the leaf's
    model dtype, fp32 master and ``states`` fp32 state buffers."""
    out = []
    for _, shape, dt in leaves:
        grad = (0.01 * torch.randn(shape, generator=g, device=dev)).to(dt)
        p = 0.05 * torch.randn(shape, generator=g, device=dev)
        st = [0.01 * torch.randn(shape, generator=g, device=dev).abs()
              for _ in range(states)]
        out.append((grad, p, *st))
    return out


def _step_leaves(step, bufs, leaves, hyp):
    """``step`` over clones of every leaf's master and state; the model
    copy in the leaf's dtype (None for an fp32 leaf).  Returns the
    outputs, per leaf."""
    outs = []
    for (grad, *state), (_, _, dt) in zip(bufs, leaves):
        st = [t.clone() for t in state]
        lowp = None if dt == torch.float32 else torch.empty_like(grad)
        step(grad, *st, lowp, **hyp)
        outs.append(st + ([] if lowp is None else [lowp]))
    return outs


def _step_leaves_once(step, name, bufs, leaves, hyp):
    """One ``step`` call (a ``*_step_leaves``) over clones of every leaf's
    master and state, the model copy in the leaf's dtype (None for an
    fp32 leaf).  Returns the outputs, per leaf, and the launches of
    kernel ``name`` it made."""
    states = [[t.clone() for t in state] for _, *state in bufs]
    lows = [None if dt == torch.float32 else torch.empty_like(b[0])
            for b, (_, _, dt) in zip(bufs, leaves)]
    n = _launched(name, lambda: step([b[0] for b in bufs], *zip(*states),
                                     lows, **hyp))
    return [st + ([] if lowp is None else [lowp])
            for st, lowp in zip(states, lows)], n


def _bitwise(label, got, want) -> float:
    """Max |got - want| over paired tensor lists; raises unless every
    pair is bitwise equal (NaN-free inputs)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} tensors against "
                             f"{len(want)}")
    err = 0.0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(err, max_err(a, b), 1e-30)
    if err:
        raise AssertionError(f"{label}: kernel differs from its plain "
                             f"version (max |err| {err:.3e})")
    return err


def _odd_cases(dev, g, step, plain, hyp, states: int, grid):
    """Kernel against plain, bitwise, over ``grid`` (flag dicts) on an
    odd length (the scalar tail) with each (g, lowp) dtype pair, and
    once on views one element off alignment (the scalar path)."""
    n = OPT_ODD_N
    grad = torch.randn(n + 1, generator=g, device=dev)
    p = torch.randn(n + 1, generator=g, device=dev)
    st = [0.1 * torch.randn(n + 1, generator=g, device=dev).abs()
          for _ in range(states)]
    cases = 0
    for flags in grid:
        for gdt, ldt in ((torch.float32, None),
                         (torch.bfloat16, torch.bfloat16),
                         (torch.float16, torch.float16)):
            for off in ((0, 1) if gdt == torch.bfloat16 else (0,)):
                gg = grad.to(gdt)[off:off + n]
                outs = []
                for fn in (step, plain):
                    ps = [t[off:off + n].clone() if off == 0 else
                          t.clone()[off:off + n] for t in [p] + st]
                    lowp = None if ldt is None else torch.empty(
                        n + 1, dtype=ldt, device=dev)[off:off + n]
                    fn(gg, *ps, lowp, **hyp, **flags)
                    outs.append(ps + ([] if lowp is None else [lowp]))
                torch.cuda.synchronize()
                _bitwise(f"{flags} g {gdt} lowp {ldt} offset {off}",
                         outs[0], outs[1])
                cases += 1
    return cases


def _opt_entry(name, shape, leaves, bufs, kernel_fn, plain_fn, lib_fn,
               bytes_per_elem_extra, flops_per_elem):
    """Time one whole-model step: kernel, plain version, library call;
    the bound from the bytes each leaf's step must move."""
    ms, ms_w = time_ms(kernel_fn)
    try:
        plain, plain_w = time_ms(plain_fn, iters=5)
    except RuntimeError:
        # ~12 launches a leaf: more than the launch queue holds behind
        # one sleep, so the device time is not separable; back to back
        # the device runs no faster than this
        plain_w = time_ms_wall(plain_fn, iters=5)
        plain = plain_w
    lib, lib_w = time_ms(lib_fn)
    nbytes = flops = 0.0
    for (grad, *_), (_, _, dt) in zip(bufs, leaves):
        n = grad.numel()
        copy = 0 if dt == torch.float32 else grad.element_size()
        nbytes += n * (grad.element_size() + bytes_per_elem_extra + copy)
        flops += n * flops_per_elem
    b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOPS)
    log(f"  {name}: time, device ms (wall ms) of the whole step: kernel "
        f"{ms:.5f} ({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), "
        f"library {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} ({b_by}, "
        f"{nbytes / 1e6:.1f} MB)")
    return dict(name=name, shape=shape, ms=ms, ms_wall=ms_w,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)


def step_launches(dtypes, lib: str) -> int:
    """The launches of one leaf-table step over leaves of model dtypes
    ``dtypes``: one a (g, copy) dtype pair (an fp32 leaf: fp32 g, no
    copy) and table of ``step_capacity(lib)`` leaves."""
    from apex_tpu_torch.ops import step_capacity

    cap = step_capacity(lib)
    groups = {}
    for dt in dtypes:
        groups[dt] = groups.get(dt, 0) + 1
    return sum(-(-k // cap) for k in groups.values())


def staged_launches(aopt, lib: str = "fused_sgd") -> int:
    """The optimizer's launches a step of amp's staged route."""
    return step_launches([p.dtype for _, p in aopt.params], lib)


def _launched(name, fn) -> int:
    """Run ``fn()``; the launches of kernel ``name`` it made."""
    from apex_tpu_torch.ops import launch_counts

    before = launch_counts()[name]
    fn()
    return launch_counts()[name] - before


def _table_overflow(dev, g, name, steps, plain, hyp, states: int) -> int:
    """More leaves than one table holds, in one (bf16 g, bf16 copy)
    group beside an fp32 and an fp16 group: lengths 1 to 2 chunks and
    odd, one master a view one element off alignment; kernel against
    plain, bitwise, and the launches counted.  Returns the leaves."""
    from apex_tpu_torch.ops import fused_optim, step_capacity

    lib = {"sgd_step": "fused_sgd", "adam_step": "fused_adam"}[name]
    cap = step_capacity(lib)
    chunk = fused_optim.STEP_CHUNK
    lens = [1 + (i * 7919) % (2 * chunk + 3) for i in range(cap + 9)]
    dts = [torch.bfloat16] * (cap + 5) + [torch.float32] * 3 + \
        [torch.float16]
    leaves, outs = [], []
    for i, (n, dt) in enumerate(zip(lens, dts)):
        grad = (0.01 * torch.randn(n, generator=g, device=dev)).to(dt)
        base = [0.05 * torch.randn(n + 1, generator=g, device=dev)] + [
            0.01 * torch.randn(n + 1, generator=g, device=dev).abs()
            for _ in range(states)]
        off = 1 if i == cap else 0
        leaves.append((grad, [t[off:off + n] for t in base], dt))
    for fn in (steps, None):
        # copies at the views' own offsets: the misaligned one stays so
        bufs = [[torch.empty(t.storage_offset() + t.numel(), device=dev)[
            t.storage_offset():].copy_(t) for t in st] for _, st, _ in leaves]
        lows = [None if dt == torch.float32 else
                torch.empty_like(grad) for grad, _, dt in leaves]
        if fn is None:
            for (grad, _, _), st, lowp in zip(leaves, bufs, lows):
                plain(grad, *st, lowp, **hyp)
        else:
            grads = [x[0] for x in leaves]
            n_launch = _launched(name, lambda: fn(
                grads, *zip(*bufs), lows, **hyp))
        outs.append([t for st, lowp in zip(bufs, lows)
                     for t in st + ([] if lowp is None else [lowp])])
    torch.cuda.synchronize()
    _bitwise(f"{name} over {len(leaves)} leaves ({cap} a table)", outs[0],
             outs[1])
    want = step_launches(dts, lib)
    if n_launch != want or want != 4:
        raise AssertionError(f"{name}: {n_launch} launches over "
                             f"{len(leaves)} leaves, want {want}")
    return len(leaves)


def _chunk_times(run):
    """The whole step's device ms at each of ``STEP_CHUNKS`` elements a
    block (``fused_optim.STEP_CHUNK`` restored after)."""
    from apex_tpu_torch.ops import fused_optim

    keep = fused_optim.STEP_CHUNK
    out = {}
    try:
        for c in STEP_CHUNKS:
            fused_optim.STEP_CHUNK = c
            out[c] = time_ms(run)[0]
    finally:
        fused_optim.STEP_CHUNK = keep
    return out


def check_sgd_step(dev, g):
    """Row 19's SGD step over ResNet-50's 161 real leaves in one
    ``sgd_step_leaves`` call (bf16 g and copy on the conv/fc leaves, fp32
    g on the batch norms') at bench_resnet50's hyperparameters, bitwise
    against the plain version, its launches counted; the flag grid on an
    odd length and misaligned views through the one-leaf ``sgd_step``;
    more leaves than a table holds; times of the whole 161-leaf step at
    each chunk size and beside the library's."""
    from apex_tpu_torch.ops import (fused_optim, sgd_step, sgd_step_leaves,
                                    sgd_step_reference)

    leaves = resnet50_leaves()
    bufs = _leaf_buffers(dev, g, leaves, 1)
    hyp = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=1e-4,
               nesterov=False, wd_after_momentum=False, first_run=False)
    per_step = step_launches([dt for _, _, dt in leaves], "fused_sgd")
    k, launches = _step_leaves_once(sgd_step_leaves, "sgd_step", bufs,
                                    leaves, hyp)
    torch.cuda.synchronize()
    r = _step_leaves(sgd_step_reference, bufs, leaves, hyp)
    err = _bitwise("sgd_step_leaves (ResNet-50 leaves)",
                   [t for o in k for t in o], [t for o in r for t in o])
    if launches != per_step:
        raise AssertionError(f"sgd_step_leaves: {launches} launches, want "
                             f"{per_step}")
    cases = _odd_cases(dev, g, sgd_step, sgd_step_reference,
                       dict(lr=0.1, momentum=0.9, weight_decay=1e-4), 1,
                       [dict(nesterov=a, dampening=b, wd_after_momentum=c,
                             first_run=d) for a, b, c, d in SGD_FLAGS])
    over = _table_overflow(dev, g, "sgd_step", sgd_step_leaves,
                           sgd_step_reference, hyp, 1)
    n = sum(int(np.prod(s)) for _, s, _ in leaves)
    log(f"kernel sgd_step: ResNet-50's {len(leaves)} leaves ({n} elements) "
        f"in one sgd_step_leaves call, {launches} launches (chunk "
        f"{fused_optim.STEP_CHUNK}), bitwise equal to the plain version; "
        f"{cases} flag/dtype cases at n={OPT_ODD_N} (and misaligned views) "
        f"through the one-leaf sgd_step and {over} leaves over 4 tables "
        f"bitwise equal ok")
    g32 = [b[0].float() for b in bufs]
    ps = [b[1].clone() for b in bufs]
    ms_ = [b[2].clone() for b in bufs]
    lows = [None if dt == torch.float32 else torch.empty_like(b[0])
            for b, (_, _, dt) in zip(bufs, leaves)]
    grads = [b[0] for b in bufs]

    def run():
        sgd_step_leaves(grads, ps, ms_, lows, **hyp)

    def plain():
        for b, p, m, lowp in zip(bufs, ps, ms_, lows):
            sgd_step_reference(b[0], p, m, lowp, **hyp)

    chunks = _chunk_times(run)
    log("  sgd_step: device ms of the whole step by chunk: " + ", ".join(
        f"{c} {t:.5f}" for c, t in chunks.items()))
    e = _opt_entry(
        "sgd_step", f"ResNet-50's {len(leaves)} leaves, {n} elements (bf16 "
        f"g and copy on 55, fp32 on 106), {per_step} launches", leaves,
        bufs, run, plain,
        lambda: torch._fused_sgd_(
            ps, g32, ms_, weight_decay=1e-4, momentum=0.9, lr=0.1,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), 16, 8)
    e["max_abs_err"] = err
    e["launches_a_step"] = per_step
    e["chunk_ms"] = chunks
    return e


def check_adam_step(dev, g):
    """Row 19's Adam step over ResNet-50's 161 leaves in one
    ``adam_step_leaves`` call, bitwise against the plain version (AdamW,
    ``main_amp``'s ``fused_adam``), its launches counted; the L2 mode and
    the dtype pairs on an odd length through the one-leaf ``adam_step``;
    more leaves than a table holds; times of the whole step."""
    from apex_tpu_torch.ops import (adam_step, adam_step_leaves,
                                    adam_step_reference, fused_optim)

    leaves = resnet50_leaves()
    bufs = _leaf_buffers(dev, g, leaves, 2)
    hyp = dict(lr=RESNET_ADAM_LR, beta1=0.9, beta2=0.999, eps=1e-8,
               weight_decay=1e-4, bias_correction1=1 - 0.9 ** 3,
               bias_correction2=1 - 0.999 ** 3, adam_w_mode=True)
    per_step = step_launches([dt for _, _, dt in leaves], "fused_adam")
    k, launches = _step_leaves_once(adam_step_leaves, "adam_step", bufs,
                                    leaves, hyp)
    torch.cuda.synchronize()
    r = _step_leaves(adam_step_reference, bufs, leaves, hyp)
    err = _bitwise("adam_step_leaves (ResNet-50 leaves)",
                   [t for o in k for t in o], [t for o in r for t in o])
    if launches != per_step:
        raise AssertionError(f"adam_step_leaves: {launches} launches, want "
                             f"{per_step}")
    base = {k_: v for k_, v in hyp.items() if k_ != "adam_w_mode"}
    cases = _odd_cases(dev, g, adam_step, adam_step_reference, base, 2,
                       [dict(adam_w_mode=True), dict(adam_w_mode=False)])
    over = _table_overflow(dev, g, "adam_step", adam_step_leaves,
                           adam_step_reference, hyp, 2)
    n = sum(int(np.prod(s)) for _, s, _ in leaves)
    log(f"kernel adam_step: ResNet-50's {len(leaves)} leaves in one "
        f"adam_step_leaves call, {launches} launches (chunk "
        f"{fused_optim.STEP_CHUNK}), bitwise equal to the plain version; "
        f"{cases} mode/dtype cases at n={OPT_ODD_N} (and misaligned views) "
        f"through the one-leaf adam_step and {over} leaves over 4 tables "
        f"bitwise equal ok")
    g32 = [b[0].float() for b in bufs]
    ps = [b[1].clone() for b in bufs]
    m1 = [b[2].clone() for b in bufs]
    v1 = [b[3].clone() for b in bufs]
    lows = [None if dt == torch.float32 else torch.empty_like(b[0])
            for b, (_, _, dt) in zip(bufs, leaves)]
    steps = [torch.full((), 3.0, device=dev) for _ in bufs]
    grads = [b[0] for b in bufs]

    def run():
        adam_step_leaves(grads, ps, m1, v1, lows, **hyp)

    def plain():
        for b, p, m, v, lowp in zip(bufs, ps, m1, v1, lows):
            adam_step_reference(b[0], p, m, v, lowp, **hyp)

    chunks = _chunk_times(run)
    log("  adam_step: device ms of the whole step by chunk: " + ", ".join(
        f"{c} {t:.5f}" for c, t in chunks.items()))
    e = _opt_entry(
        "adam_step", f"ResNet-50's {len(leaves)} leaves, {n} elements (bf16 "
        f"g and copy on 55, fp32 on 106), {per_step} launches", leaves,
        bufs, run, plain,
        lambda: torch._fused_adamw_(
            ps, g32, m1, v1, [], steps, lr=RESNET_ADAM_LR, beta1=0.9,
            beta2=0.999, weight_decay=1e-4, eps=1e-8, amsgrad=False,
            maximize=False), 24, 16)
    e["max_abs_err"] = err
    e["launches_a_step"] = per_step
    e["chunk_ms"] = chunks
    return e


def check_sgd_pipeline(dev, g):
    """Row 19's SGD pipeline sweep over one packed group of ResNet-50's
    element count (bf16 g and copy, fp32 master and momentum), its scale
    and skip flag read from device memory: keep=1 bitwise against the
    plain version, keep=0 leaving master and momentum bitwise unchanged
    with the copy the cast of the old master; the flag grid with keep 0/1
    on an odd length; times."""
    from apex_tpu_torch.ops import sgd_pipeline, sgd_pipeline_reference

    n = sum(int(np.prod(s)) for _, s, _ in resnet50_leaves())
    grad = (0.01 * torch.randn(n, generator=g, device=dev)).bfloat16()
    p0 = 0.05 * torch.randn(n, generator=g, device=dev)
    m0 = 0.01 * torch.randn(n, generator=g, device=dev)
    hyp = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=1e-4,
               nesterov=False, wd_after_momentum=False, first_run=False)
    gs = torch.full((), 0.5, device=dev)
    outs = []
    for fn in (sgd_pipeline, sgd_pipeline_reference):
        p, m = p0.clone(), m0.clone()
        low = torch.empty(n, dtype=torch.bfloat16, device=dev)
        fn(grad, p, m, low, grad_scale=gs, keep=True, **hyp)
        outs.append((p, m, low))
    torch.cuda.synchronize()
    err = _bitwise("sgd_pipeline keep=1", outs[0], outs[1])
    p, m = p0.clone(), m0.clone()
    low = torch.empty(n, dtype=torch.bfloat16, device=dev)
    sgd_pipeline(grad, p, m, low, grad_scale=gs,
                 keep=torch.zeros((), dtype=torch.bool, device=dev), **hyp)
    torch.cuda.synchronize()
    if not (torch.equal(p, p0) and torch.equal(m, m0)
            and torch.equal(low, p0.bfloat16())):
        raise AssertionError("sgd_pipeline keep=0 moved the state")
    grid = [dict(nesterov=a, dampening=b, wd_after_momentum=c, first_run=d,
                 keep=kp, grad_scale=0.25)
            for a, b, c, d in SGD_FLAGS for kp in (True, False)]
    cases = _odd_cases(dev, g, sgd_pipeline, sgd_pipeline_reference,
                       dict(lr=0.1, momentum=0.9, weight_decay=1e-4), 1,
                       grid)
    log(f"kernel sgd_pipeline: n={n} bf16 g, fp32 p/mom, bf16 copy, device "
        f"scale 0.5: keep=1 bitwise equal to the plain version; keep=0 "
        f"(a device flag) leaves p/mom bitwise and the copy = bf16(p); "
        f"{cases} flag/keep/dtype cases at n={OPT_ODD_N} bitwise equal ok")
    low = torch.empty(n, dtype=torch.bfloat16, device=dev)
    g32 = [grad.float()]
    inv = torch.full((), 2.0, device=dev)
    found = torch.zeros((), device=dev)
    bufs = [(grad,)]
    leaves = [("flat", (n,), torch.bfloat16)]
    e = _opt_entry(
        "sgd_pipeline", f"one packed group, n={n} (ResNet-50's elements), "
        f"bf16 g and copy, device scale and flag", leaves, bufs,
        lambda: sgd_pipeline(grad, p, m, low, grad_scale=gs, keep=True,
                             **hyp),
        lambda: sgd_pipeline_reference(grad, p, m, low, grad_scale=gs,
                                       keep=True, **hyp),
        lambda: torch._fused_sgd_(
            [p], g32, [m], weight_decay=1e-4, momentum=0.9, lr=0.1,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False, grad_scale=inv, found_inf=found), 16, 9)
    e["max_abs_err"] = err
    return e


# --- phase 2, the update slice's kernels (row 19's update bodies) -------

def _update_bodies():
    """(name, kernel, plain version, fp32 state buffers, hyperparameters,
    flag grid) of the four update bodies."""
    from apex_tpu_torch.ops import fused_optim as fo

    sgd_grid = [dict(nesterov=a, dampening=b, wd_after_momentum=c,
                     first_run=d) for a, b, c, d in SGD_FLAGS]
    return (
        ("adam_update", fo.adam_update, fo.adam_update_reference, 2,
         UPDATE_ADAM, [dict(adam_w_mode=True), dict(adam_w_mode=False)]),
        ("adagrad_update", fo.adagrad_update, fo.adagrad_update_reference,
         1, UPDATE_ADAGRAD, [{}]),
        ("novograd_update", fo.novograd_update,
         fo.novograd_update_reference, 2, UPDATE_NOVOGRAD,
         [dict(beta3=1.0 - 0.95), dict(beta3=1.0)]),
        ("sgd_update", fo.sgd_update, fo.sgd_update_reference, 1,
         UPDATE_SGD, sgd_grid))


def _update_library(name, g32, p, st):
    """One PyTorch call doing ``name``'s work on the same inputs (in place
    on p and the state: no delta written), or None where PyTorch has
    none."""
    step = [torch.full((), 3.0, device=p.device)]
    if name == "adam_update":
        h = UPDATE_ADAM
        return lambda: torch._fused_adamw_(
            [p], [g32], [st[0]], [st[1]], [], step, lr=h["lr"],
            beta1=h["beta1"], beta2=h["beta2"], weight_decay=h["weight_decay"],
            eps=h["eps"], amsgrad=False, maximize=False)
    if name == "adagrad_update":
        h = UPDATE_ADAGRAD
        return lambda: torch._fused_adagrad_(
            [p], [g32], [st[0]], step, lr=h["lr"], lr_decay=0.0,
            weight_decay=h["weight_decay"], eps=h["eps"], maximize=False)
    if name == "sgd_update":
        h = UPDATE_SGD
        return lambda: torch._fused_sgd_(
            [p], [g32], [st[0]], weight_decay=h["weight_decay"],
            momentum=h["momentum"], lr=h["lr"], dampening=0.0,
            nesterov=False, maximize=False, is_first_step=False)
    return None              # NovoGrad: no PyTorch call


def check_optim_update(dev, g):
    """Row 19's four update bodies, each bitwise against its plain version
    on the card at every (g, p) pair of fp32, bf16 and fp16 and every flag
    (Adam's two modes, NovoGrad with and without grad averaging, SGD's
    Nesterov, dampening, decay after the momentum and first run) on an odd
    length, and on views one element off alignment (the scalar path); then
    timed at row 19's n = 67,108,864 with bf16 g and fp32 p (AdamW,
    NovoGrad averaging, plain momentum SGD) beside the plain version, the
    bound and, where one exists, PyTorch's fused in-place step."""
    n = OPT_ODD_N
    base_g = torch.randn(n + 1, generator=g, device=dev)
    base_p = torch.randn(n + 1, generator=g, device=dev)
    base_s = [0.1 * torch.randn(n + 1, generator=g, device=dev).abs() + 0.01
              for _ in range(2)]
    out = []
    for name, kernel, plain, states, hyp, grid in _update_bodies():
        cases = 0
        for flags in grid:
            for gdt in UPDATE_DTYPES:
                for pdt in UPDATE_DTYPES:
                    both16 = gdt == pdt == torch.bfloat16
                    for off in ((0, 1) if both16 else (0,)):
                        args = [base_g.to(gdt)[off:off + n],
                                base_p.to(pdt)[off:off + n]] + \
                            [t[off:off + n] for t in base_s[:states]]
                        got = kernel(*args, **hyp, **flags)
                        torch.cuda.synchronize()
                        want = plain(*args, **hyp, **flags)
                        _bitwise(f"{name} {flags} g {gdt} p {pdt} offset "
                                 f"{off}", got, want)
                        cases += 1
        log(f"kernel {name}: {cases} flag/dtype cases at n={n} (g and p "
            f"each fp32, bf16, fp16; bf16 views one element off alignment) "
            f"bitwise equal to the plain version ok")
        # the timing shape
        N = UPDATE_N
        gb = (0.01 * torch.randn(N, generator=g, device=dev)).bfloat16()
        p = torch.randn(N, generator=g, device=dev)
        st = [0.01 * torch.randn(N, generator=g, device=dev).abs() + 0.01
              for _ in range(states)]
        flags = grid[0]
        ms, ms_w = time_ms(lambda: kernel(gb, p, *st, **hyp, **flags))
        plain_ms, plain_w = time_ms(
            lambda: plain(gb, p, *st, **hyp, **flags), iters=5)
        lib = _update_library(name, gb.float(), p.clone(),
                              [t.clone() for t in st])
        lib_ms = lib_w = None
        lib_txt = "none (no PyTorch call)"
        if lib is not None:
            lib_ms, lib_w = time_ms(lib)
            lib_txt = f"{lib_ms:.5f} ({lib_w:.5f}, in place, fp32 g)"
        b_ms, b_by = bound_ms(UPDATE_BYTES[name] * N,
                              UPDATE_FLOPS[name] * N, FP32_FLOPS)
        log(f"  {name} n={N} bf16 g, fp32 p, {flags or 'defaults'}: time, "
            f"device ms (wall ms per call): kernel {ms:.5f} ({ms_w:.5f}), "
            f"plain {plain_ms:.5f} ({plain_w:.5f}), library {lib_txt}, bound "
            f"{b_ms:.5f} ({b_by}, {UPDATE_BYTES[name]} bytes an element)")
        out.append(dict(name=name, shape=f"n={N} bf16 g, fp32 p and state"
                        f"{', ' + str(flags) if flags else ''}", ms=ms,
                        ms_wall=ms_w, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms, max_abs_err=0.0))
        del gb, p, st, lib
        free_memory()
    return tuple(out)


def long_context(dev):
    """bench.py's bench_long_context on the port: at each shape, q, k, v
    drawn bf16 (randn * 0.5) and ``flash_attention(q, k, v,
    causal=True)`` forward and backward under autograd with the loss
    sum(o.float() ** 2), launch counts reset just before the five
    substeps and held exactly; then, outside the count, each shape held
    against the plain versions on its first heads and timed.  Returns
    the counts."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention,
                                    flash_attention_backward,
                                    flash_attention_backward_reference,
                                    flash_attention_with_lse,
                                    launch_counts, mha_reference,
                                    reset_launch_counts)

    g = torch.Generator(device=dev)
    g.manual_seed(8)
    cases = []
    for b, h, s, d in LONG_CONTEXT_SHAPES:
        q, k, v = ((0.5 * torch.randn(b, h, s, d, generator=g, device=dev))
                   .bfloat16() for _ in range(3))
        cases.append((q, k, v))
    reset_launch_counts()
    t0 = time.perf_counter()
    grads = []
    for q, k, v in cases:
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention(*qkv, causal=True)
        (o.float() ** 2).sum().backward()
        grads.append(tuple(t.grad for t in qkv))
        del o, qkv
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = len(LONG_CONTEXT_SHAPES)
    want = {k: 0 for k in counts}
    want.update(flash_attention=n, flash_attention_bwd=n)
    log(f"long_context: {n} substeps (forward and backward under autograd, "
        f"loss sum(o**2)) in {wall:.2f} s; launch counts "
        f"{ {k: v for k, v in counts.items() if v} } (expected "
        f"{ {k: v for k, v in want.items() if v} })")
    if counts != want:
        raise AssertionError(f"long_context launch counts {counts} != "
                             f"{want}")
    for (b, h, s, d), (q, k, v), (dq, dk, dv) in zip(LONG_CONTEXT_SHAPES,
                                                    cases, grads):
        shape = f"b={b} h={h} s={s} d={d} causal bf16"
        hs = max(1, min(h, LONG_CONTEXT_PLAIN_ELEMS // (s * s)))
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
        do = 2 * o
        sub = [t[:, :hs] for t in (q, k, v, o, lse, do)]
        o_r, lse_r = mha_reference(*sub[:3], causal=True, return_lse=True)
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"long_context forward at {shape}: o is "
                                 f"not finite")
        _hold_forward(f"long_context flash_attention {shape} (heads "
                      f"0..{hs - 1} of {h})", sub[3], o_r, sub[4], lse_r)
        del o_r, lse_r
        want = flash_attention_backward_reference(*sub, causal=True)
        _hold_backward(f"long_context flash_attention_bwd {shape} (heads "
                       f"0..{hs - 1} of {h}, the autograd run's gradients)",
                       [t[:, :hs] for t in (dq, dk, dv)], want)
        del want
        fms, fms_w = time_ms(lambda: flash_attention_with_lse(
            q, k, v, causal=True), iters=3, warmup=1)
        bms, bms_w = time_ms(lambda: flash_attention_backward(
            q, k, v, o, lse, do, causal=True), iters=3, warmup=1)
        pf, _ = time_ms(lambda: mha_reference(*sub[:3], causal=True,
                                              return_lse=True), iters=3,
                        warmup=1)
        pb, _ = time_ms(lambda: flash_attention_backward_reference(
            *sub, causal=True), iters=3, warmup=1)
        lf, _ = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=5, warmup=1)
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        out_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lb, _ = time_ms(lambda: torch.autograd.grad(
            out_s, (qs, ks, vs), do, retain_graph=True), iters=5, warmup=1)
        del out_s, qs, ks, vs
        fb, fby = _attn_bound(b, h, s, d, True, bwd=False)
        bb, bby = _attn_bound(b, h, s, d, True, bwd=True)
        flops = 7.0 * b * h * s * s * d
        tf = flops / ((fms + bms) / 1e3) / 1e12
        log(f"  time {shape}, device ms (wall ms per call): forward kernel "
            f"{fms:.5f} ({fms_w:.5f}), SDPA {lf:.5f}, bound {fb:.5f} "
            f"({fby}); backward kernel {bms:.5f} ({bms_w:.5f}), SDPA "
            f"backward {lb:.5f}, bound {bb:.5f} ({bby}); plain versions on "
            f"{hs} of {h} heads: forward {pf:.5f}, backward {pb:.5f}; the "
            f"substep ({flops / 1e12:.4f} TFLOP at 7 b h s^2 d) "
            f"{fms + bms:.5f} ms, {tf:.3f} model TFLOP/s "
            f"({100 * tf / (BF16_FLOPS / 1e12):.2f}% of 989)")
        del o, lse, do, sub
        free_memory()
    del cases, grads
    free_memory()
    return counts


def check_fp16_builds(dev, g):
    """The fp16 builds the O2 step runs: LayerNorm forward and backward
    with fp16 gamma/beta, the Adam sweep with fp16 grads and an fp16
    copy.  Returns ``{name: entry}``."""
    fwd, bwd = check_layer_norm_bwd(dev, g, torch.float16)
    free_memory()
    adam = check_fused_adam(dev, g, torch.float16)
    return {"layer_norm": fwd, "layer_norm_bwd": bwd,
            "fused_adam_pipeline": adam}


# --- phase 3 ------------------------------------------------------------

def serve_and_check(dev, *, policy: str, gap_tol: float,
                    model: str = "gpt345m", counted: bool = False):
    """Serve the smoke's requests at ``policy`` and hold every served
    token against the teacher-forced plain-version oracle.  With
    ``counted`` the launch counts are reset just before the serve and
    read just after, and every kernel must have launched."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.testing.standalone_gpt import serve_smoke

    if counted:
        reset_launch_counts()
    t0 = time.perf_counter()
    summary, engine = serve_smoke(len(SERVE_LENGTHS), model=model,
                                  policy=policy, max_new_tokens=SERVE_NEW,
                                  prompt_lengths=SERVE_LENGTHS, seed=0,
                                  device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts() if counted else None
    mc = engine.model_cfg
    log(f"serve {policy}: {model} (vocab {mc.vocab_size}, hidden "
        f"{mc.hidden_size}, {mc.num_layers} layers, {mc.num_heads} heads), "
        f"{mc.dtype}, {len(SERVE_LENGTHS)} requests, prompt lengths "
        f"{SERVE_LENGTHS}, {SERVE_NEW} new tokens each (weights + serve "
        f"{wall:.1f} s)")
    if counted:
        log(f"serve {policy}: launch counts {counts}")
        if any(counts[k] <= 0 for k in SERVE_KERNELS):
            raise AssertionError(f"a kernel of the path never launched: "
                                 f"{counts}")
    n_req = len(SERVE_LENGTHS)
    if summary.requests_done != n_req or \
            summary.tokens_generated != n_req * SERVE_NEW:
        raise AssertionError(f"served {summary.requests_done} requests / "
                             f"{summary.tokens_generated} tokens")
    check_tokens(engine, gap_tol, dev, f"serve {policy}")
    log(f"serve {policy}: tokens_per_sec={summary.tokens_per_sec} "
        f"decode_tokens_per_sec={summary.decode_tokens_per_sec} "
        f"ttft_p50_ms={summary.ttft_p50_ms} "
        f"ttft_p99_ms={summary.ttft_p99_ms} "
        f"token_p50_ms={summary.latency_p50_ms} "
        f"token_p99_ms={summary.latency_p99_ms} "
        f"itl_p50_ms={summary.itl_p50_ms} itl_p99_ms={summary.itl_p99_ms} "
        f"decode_steps={summary.decode_steps} wall_s={summary.wall_s} "
        f"digest={engine.tokens_digest()}")
    return counts, summary, engine.tokens_digest()


def _hold_tokens(label: str, gap_tol: float, streams):
    """Hold served tokens against oracle logits: ``streams`` yields
    ``(rid, out_tokens, rows)`` with ``rows`` the oracle's (n, V) logits
    for each served position.  A token must equal the oracle's argmax
    wherever its top-2 gap exceeds ``gap_tol`` (below it the position is
    a tie).  Returns ``{(rid, index): gap}`` for every served token."""
    checked = ties = mism_ties = 0
    worst = 0.0                      # the largest gap at a differing token
    gaps = {}
    for rid, out_tokens, rows in streams:
        n_new = len(out_tokens)
        if rows.shape[0] != n_new or not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"{rid}: oracle logits "
                                 f"{tuple(rows.shape)} not finite / "
                                 f"not {n_new} rows")
        top2 = rows.topk(2, dim=-1)
        gap = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        want = top2.indices[:, 0].tolist()
        for j, (got, w, gp) in enumerate(zip(out_tokens, want, gap)):
            checked += 1
            gaps[(rid, j)] = gp
            if got != w:
                worst = max(worst, gp)
            if gp <= gap_tol:
                ties += 1
                mism_ties += int(got != w)
                continue
            if got != w:
                raise AssertionError(
                    f"{label}: {rid} token {j}: served {got}, oracle "
                    f"{w} with top-2 gap {gp:.4f} > {gap_tol}")
    log(f"{label}: token check {checked} positions, {ties} under the tie "
        f"rule (top-2 gap <= {gap_tol}; {mism_ties} of them differ, the "
        f"largest gap at a differing token {worst:.4f}), the other "
        f"{checked - ties} equal the oracle")
    return gaps


def _sequence_oracle(engine, weights, dev):
    """``(rid, out_tokens, rows)`` per finished request: the logits of
    ``gpt_sequence_logits`` on ``weights`` through the plain versions,
    teacher-forced on the served stream."""
    from apex_tpu_torch.serving import gpt_sequence_logits

    mc = engine.model_cfg
    plain_cfg = mc.plain()
    for req in sorted(engine.done, key=lambda r: str(r.rid)):
        seq = req.prompt + req.out_tokens[:-1]
        toks = torch.tensor([seq], dtype=torch.long, device=dev)
        with torch.inference_mode():
            logits = gpt_sequence_logits(weights, plain_cfg,
                                         toks)[0].float()
        rows = logits[len(req.prompt) - 1:]
        if rows.shape[1] != mc.vocab_size:
            raise AssertionError(f"{req.rid}: oracle vocab {rows.shape[1]}")
        yield req.rid, req.out_tokens, rows


def check_tokens(engine, gap_tol: float, dev, label: str):
    """Hold every token ``engine`` served against the argmax of
    ``gpt_sequence_logits`` run teacher-forced through the plain versions
    on the same weights: a token must equal it wherever the oracle's
    top-2 gap exceeds ``gap_tol`` (below it the position is a tie).
    Returns ``{(rid, index): gap}`` for every served token."""
    return _hold_tokens(label, gap_tol,
                        _sequence_oracle(engine, engine.weights, dev))


def _cache_replay(engine, dev):
    """``(rid, out_tokens, rows)`` per finished request from a
    teacher-forced replay through a cache of the engine's own storage
    dtype: the prompt through the plain prefill into a fresh cache, then
    one plain decode step per served token, fed the served tokens.  The
    oracle of a serve whose cache is quantized (``gpt_sequence_logits``
    reads no cache, so it cannot model int8 k/v)."""
    import dataclasses

    from apex_tpu_torch.serving import (gpt_decode_step, gpt_prefill_step,
                                        init_cache)

    plain = engine.model_cfg.plain()
    cc = engine.cache_cfg
    bs = cc.block_size
    w = engine.weights

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    for req in sorted(engine.done, key=lambda r: str(r.rid)):
        plen, n_new = len(req.prompt), len(req.out_tokens)
        pages = cc.blocks_for(plen + n_new)
        rcfg = dataclasses.replace(cc, num_blocks=pages + 1)
        cache = init_cache(rcfg, dev)
        pp = cc.blocks_for(plen)
        toks = torch.zeros(pp * bs, dtype=torch.long, device=dev)
        toks[:plen] = torch.tensor(req.prompt, device=dev)
        bt = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)
        with torch.inference_mode():
            _, _, lg = gpt_prefill_step(w, plain, rcfg, cache, toks, plen,
                                        bt[:pp], return_logits=True)
            rows = [lg.float()]
            for j in range(n_new - 1):
                pos = plen + j
                _, _, lg = gpt_decode_step(
                    w, plain, rcfg, cache,
                    torch.tensor([req.out_tokens[j]], device=dev),
                    torch.tensor([pos], device=dev), bt[None], i32(pos + 1),
                    i32(pos // bs + 1), i32(pos % bs), return_logits=True)
                rows.append(lg[0].float())
        yield req.rid, req.out_tokens, torch.stack(rows)


# --- phase 3b: the serving fast path -----------------------------------

def _all_blocks_back(engine, label: str) -> None:
    m = engine.manager
    if engine.active or engine.prefilling or \
            m.free_blocks + m.idle_blocks != engine.cache_cfg.usable_blocks:
        raise AssertionError(f"{label}: blocks not returned (free "
                             f"{m.free_blocks}, idle {m.idle_blocks}, "
                             f"usable {engine.cache_cfg.usable_blocks})")


def _log_summary(label: str, s, engine) -> None:
    log(f"{label}: tokens_per_sec={s.tokens_per_sec} "
        f"decode_tokens_per_sec={s.decode_tokens_per_sec} "
        f"ttft_p50_ms={s.ttft_p50_ms} token_p50_ms={s.latency_p50_ms} "
        f"token_p99_ms={s.latency_p99_ms} itl_p50_ms={s.itl_p50_ms} "
        f"itl_p99_ms={s.itl_p99_ms} decode_steps={s.decode_steps} "
        f"prefill_chunks={s.prefill_chunks} spec_accept_rate="
        f"{s.spec_accept_rate} spec_proposed={s.spec_tokens_proposed} "
        f"spec_accepted={s.spec_tokens_accepted} wall_s={s.wall_s} "
        f"digest={engine.tokens_digest()}")


def _fast_leg(dev, label: str, *, policy: str = "O5",
              gap_tol: float = TOKEN_GAP_TOL, **fast):
    """Serve the serve phase's requests through ``serve_smoke`` with the
    fast-path options ``fast``, launch counts reset just before and read
    just after; every token held against the oracle.  Returns
    ``(counts, summary, engine, gaps)``."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.testing.standalone_gpt import serve_smoke

    reset_launch_counts()
    summary, engine = serve_smoke(len(SERVE_LENGTHS), policy=policy,
                                  max_new_tokens=SERVE_NEW,
                                  prompt_lengths=SERVE_LENGTHS, seed=0,
                                  device=dev, **fast)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{label}: {fast}, {engine.model_cfg.dtype}, launch counts "
        f"{ {k: v for k, v in counts.items() if v} }")
    n = len(SERVE_LENGTHS)
    if summary.requests_done != n or \
            summary.tokens_generated != n * SERVE_NEW:
        raise AssertionError(f"{label}: served {summary.requests_done} "
                             f"requests / {summary.tokens_generated} tokens")
    _all_blocks_back(engine, label)
    gaps = check_tokens(engine, gap_tol, dev, label)
    _log_summary(label, summary, engine)
    return counts, summary, engine, gaps


def _chunked_leg(dev, layers: int, policy: str = "O5",
                 kv_dtype: str = "model"):
    """Chunked prefill at CHUNK tokens, the serve's prompts arriving one
    every second tick (``run(before_tick=)``, as bench.py's chunked leg
    drips them): no whole-prompt prefill may launch, the multi-token
    kernel runs once a layer per chunk, and decode ticks run while a
    prompt is still prefilling.  Under Q8 every launch count is held
    exactly; with an int8 cache the int8 branches launch and the tokens
    are held against the int8 replay."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import (Request, ServingEngine,
                                        default_cache_config,
                                        init_serving_weights,
                                        quantize_weights)
    from apex_tpu_torch.testing.standalone_gpt import (model_config,
                                                       seeded_prompts)

    int8 = kv_dtype == "int8"
    sfx = "_int8" if int8 else ""
    label = f"serve_fast chunked {policy}" if policy == "O5" and not int8 \
        else f"serve_q8 chunked {policy} kv {kv_dtype}"
    cfg = model_config("gpt345m", policy=policy)
    weights = init_serving_weights(cfg, seed=0, device=dev)
    if policy == "Q8":
        weights = quantize_weights(weights)
    engine = ServingEngine(weights, cfg,
                           default_cache_config(cfg, kv_dtype=kv_dtype),
                           device=dev, prefill_chunk=CHUNK)
    pending = [Request(rid=f"req{i:03d}", prompt=p, max_new_tokens=SERVE_NEW)
               for i, p in enumerate(seeded_prompts(
                   SERVE_LENGTHS, cfg.vocab_size, seed=2))]
    overlap = 0

    def drip(step):
        nonlocal overlap
        if pending and step % 2 == 0:
            engine.submit(pending.pop(0))
        overlap += bool(engine.prefilling) and bool(engine.active)

    reset_launch_counts()
    engine.submit(pending.pop(0))
    s = engine.run(before_tick=drip)
    while pending:
        engine.submit(pending.pop(0))
        s = engine.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{label}: prefill_chunk={CHUNK}, one request every second tick, "
        f"launch counts { {k: v for k, v in counts.items() if v} }, "
        f"{s.prefill_chunks} chunks, {overlap} ticks decoding while a "
        f"prompt was still prefilling")
    if counts["flash_attention"] != 0:
        raise AssertionError(f"{label}: the whole-prompt prefill launched")
    if counts["flash_decode_multi" + sfx] != layers * s.prefill_chunks:
        raise AssertionError(f"{label}: flash_decode_multi{sfx} launched "
                             f"{counts['flash_decode_multi' + sfx]} times, "
                             f"not {layers} x {s.prefill_chunks} chunks")
    if counts["flash_decode" + sfx] <= 0 or overlap < 1:
        raise AssertionError(f"{label}: no decode beside the chunks")
    if policy == "Q8":
        want = q8_launches(layers, s.decode_steps, 0, s.prefill_chunks, int8)
        if counts != want:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{want}")
    if s.requests_done != len(SERVE_LENGTHS):
        raise AssertionError(f"{label}: {s.requests_done} requests done")
    _all_blocks_back(engine, label)
    if int8:
        _hold_tokens(label, TOKEN_GAP_TOL_Q8, _cache_replay(engine, dev))
    else:
        check_tokens(engine, TOKEN_GAP_TOL, dev, label)
    _log_summary(label, s, engine)
    return counts


def _share_leg(dev):
    """Prefix sharing on bench.py's shared-system-prompt trace: the cold
    pass on an engine without sharing, then a priming and a warm pass on
    a sharing engine.  Warm admissions must hit the index and copy on
    write, the bytes of every shared page must not change across the
    warm pass, and every token must match the oracle."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import (Request, ServingEngine,
                                        default_cache_config,
                                        init_serving_weights)
    from apex_tpu_torch.testing.standalone_gpt import model_config

    label = "serve_fast prefix sharing O5"
    cfg = model_config("gpt345m", policy="O5")
    weights = init_serving_weights(cfg, seed=0, device=dev)
    rng = np.random.RandomState(7)
    system = [int(t) for t in rng.randint(0, cfg.vocab_size, SHARE_SYS)]
    prompts = [system + [int(t) for t in rng.randint(0, cfg.vocab_size, 3)]
               for _ in range(SHARE_REQUESTS)]

    def serve(engine, tag):
        reqs = [Request(rid=f"{tag}{i}", prompt=p, max_new_tokens=SHARE_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        s = engine.run()
        torch.cuda.synchronize()
        return s, 1e3 * float(np.mean([r.prefill_s for r in reqs]))

    reset_launch_counts()
    cold = ServingEngine(weights, cfg, default_cache_config(cfg), device=dev)
    _, cold_ms = serve(cold, "cold")
    check_tokens(cold, TOKEN_GAP_TOL, dev, f"{label} (cold)")
    cold_digest = cold.tokens_digest()
    del cold
    free_memory()
    eng = ServingEngine(weights, cfg, default_cache_config(cfg), device=dev,
                        prefix_share=True)
    s0, prime_ms = serve(eng, "prime")
    blocks = sorted({b for p in prompts
                     for b in eng.manager.match_prefix(p).blocks})
    before = (eng.cache.k[:, blocks].clone(), eng.cache.v[:, blocks].clone())
    hits0, cow0, warm0 = s0.prefix_hit_tokens, s0.cow_copies, \
        s0.warm_prefix_admissions
    s, warm_ms = serve(eng, "warm")
    counts = launch_counts()
    same = torch.equal(eng.cache.k[:, blocks], before[0]) and \
        torch.equal(eng.cache.v[:, blocks], before[1])
    log(f"{label}: {SHARE_REQUESTS} requests of a {SHARE_SYS}-token system "
        f"prompt + 3 tokens, {SHARE_NEW} new each; admission (first token) "
        f"mean ms: cold {cold_ms:.3f}, priming pass {prime_ms:.3f}, warm "
        f"{warm_ms:.3f}; warm pass: {s.warm_prefix_admissions - warm0} warm "
        f"admissions, {s.prefix_hit_tokens - hits0} prefix hit tokens, "
        f"{s.cow_copies - cow0} copies on write; shared_blocks_hw "
        f"{s.shared_blocks_hw}; {len(blocks)} shared pages unchanged "
        f"across the warm pass: {same}; launch counts "
        f"{ {k: v for k, v in counts.items() if v} }")
    if s.warm_prefix_admissions - warm0 != SHARE_REQUESTS or \
            s.prefix_hit_tokens <= hits0 or s.cow_copies <= cow0:
        raise AssertionError(f"{label}: warm admissions did not hit and "
                             f"copy on write")
    if not same or not blocks:
        raise AssertionError(f"{label}: a shared page changed")
    _all_blocks_back(eng, label)
    check_tokens(eng, TOKEN_GAP_TOL, dev, f"{label} (prime + warm)")
    warm_tokens = {r.rid[4:]: r.out_tokens for r in eng.done
                   if r.rid.startswith("warm")}
    prime_tokens = {r.rid[5:]: r.out_tokens for r in eng.done
                    if r.rid.startswith("prime")}
    log(f"{label}: warm streams equal the priming pass's: "
        f"{warm_tokens == prime_tokens}; cold digest {cold_digest}")
    return counts


def _spec_self_leg(dev, plain, layers: int):
    """Speculation with the target as its own draft at O5: the
    multi-token kernel launches once a layer per verify tick, the draft's
    decode and prefill kernels launch, and the serve takes fewer ticks
    than the plain one (``plain``: its ``(summary, digest)``, served here
    when the serve phase did not run)."""
    from apex_tpu_torch.testing.standalone_gpt import serve_smoke

    if plain is None:
        s, e = serve_smoke(len(SERVE_LENGTHS), max_new_tokens=SERVE_NEW,
                           prompt_lengths=SERVE_LENGTHS, seed=0, device=dev)
        plain = (s, e.tokens_digest())
        del e
    label = "serve_fast spec self O5"
    c, s, eng, _ = _fast_leg(dev, label, speculate_k=SPEC_K, draft="self")
    log(f"{label}: acceptance {s.spec_accept_rate} ({s.spec_tokens_accepted}"
        f" of {s.spec_tokens_proposed}), {s.decode_steps} ticks (plain "
        f"serve {plain[0].decode_steps}); digest {eng.tokens_digest()}, "
        f"plain serve's {plain[1]}")
    if s.spec_disabled or c["flash_decode_multi"] != layers * s.decode_steps:
        raise AssertionError(f"{label}: flash_decode_multi launched "
                             f"{c['flash_decode_multi']} times, not {layers} "
                             f"x {s.decode_steps} verify ticks")
    if c["flash_decode"] <= 0 or c["flash_attention"] <= 0:
        raise AssertionError(f"{label}: draft decode or prefill never "
                             f"launched")
    if s.decode_steps >= plain[0].decode_steps:
        raise AssertionError(f"{label}: {s.decode_steps} ticks, the plain "
                             f"serve {plain[0].decode_steps}")
    return c


def _spec_fp32_leg(dev):
    """The self draft in fp32: a draft token may be rejected only where
    the oracle's top-2 gap is a near-tie."""
    label = "serve_fast spec self O0"
    c, s, eng, gaps = _fast_leg(dev, label, policy="O0",
                                gap_tol=TOKEN_GAP_TOL_FP32,
                                speculate_k=SPEC_K, draft="self")
    rejected = [(r, j, round(gaps[(r, j)], 6)) for r, j in eng.spec_rejections]
    log(f"{label}: acceptance {s.spec_accept_rate} ({s.spec_tokens_accepted}"
        f" of {s.spec_tokens_proposed}); rejections (rid, token, oracle "
        f"top-2 gap): {rejected}")
    for r, j, gap in rejected:
        if gap > TOKEN_GAP_TOL_FP32:
            raise AssertionError(f"{label}: {r} token {j} rejected with "
                                 f"top-2 gap {gap}")
    return c


def _spec_truncated_leg(dev, layers: int):
    """A truncated draft and no governor: proposals accepted and
    rejected, rows rolled back (``_fast_leg`` checks every block came
    back)."""
    label = "serve_fast spec truncated O5"
    c, s, eng, _ = _fast_leg(dev, label, speculate_k=SPEC_K,
                             draft="truncated", spec_governor=None)
    log(f"{label}: draft = the first {eng.draft_cfg.num_layers} of {layers} "
        f"layers; "
        f"acceptance {s.spec_accept_rate} ({s.spec_tokens_accepted} of "
        f"{s.spec_tokens_proposed}), {len(eng.spec_rejections)} rows rolled "
        f"back, {s.decode_steps} ticks; free blocks "
        f"{eng.manager.free_blocks} of {eng.cache_cfg.usable_blocks}")
    if not 0.0 < s.spec_accept_rate < 1.0 or not eng.spec_rejections:
        raise AssertionError(f"{label}: acceptance {s.spec_accept_rate}, "
                             f"{len(eng.spec_rejections)} rollbacks")
    return c


def serve_fast_legs(plain):
    """The five fast-path legs at GPT-345M width, each ``(name, fn(dev))``
    returning its launch counts."""
    from apex_tpu_torch.testing.standalone_gpt import MODELS

    layers = MODELS["gpt345m"]["num_layers"]
    return (("spec self O5", lambda dev: _spec_self_leg(dev, plain, layers)),
            ("spec self O0", _spec_fp32_leg),
            ("spec truncated O5",
             lambda dev: _spec_truncated_leg(dev, layers)),
            ("chunked O5", lambda dev: _chunked_leg(dev, layers)),
            ("prefix sharing O5", _share_leg))


# --- phase 3c: the quantized serving tier ------------------------------

def q8_launches(layers: int, ticks: int, prefills: int, chunks: int,
                int8: bool):
    """Every kernel's launches for a Q8 serve of ``ticks`` decode ticks
    (a batch of at most 8 rows: the GEMV), ``prefills`` whole-prompt
    prefills and ``chunks`` prefill chunks (both more than 8 rows: the
    tiled kernel), with a float or an int8 cache."""
    from apex_tpu_torch.ops import KERNELS

    sfx = "_int8" if int8 else ""
    want = {k: 0 for k in KERNELS}
    want.update(layer_norm=(2 * layers + 1) * (ticks + prefills + chunks),
                flash_attention=layers * prefills,
                quant_gemv=4 * layers * ticks,
                quant_tiled=4 * layers * (prefills + chunks))
    want["flash_decode" + sfx] = layers * ticks
    want["flash_decode_multi" + sfx] = layers * chunks
    return want


def _q8_leg(dev, layers: int, kv_dtype: str):
    """The Q8 serve of the serve phase's requests through ``serve_smoke``
    with the cache stored as ``kv_dtype``, launch counts reset just before
    and held exactly; every block back; every token against the int8
    replay (int8 cache) or ``gpt_sequence_logits`` on the Q8 weights."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.testing.standalone_gpt import serve_smoke

    label = f"serve_q8 Q8 kv {kv_dtype}"
    int8 = kv_dtype == "int8"
    reset_launch_counts()
    t0 = time.perf_counter()
    summary, engine = serve_smoke(len(SERVE_LENGTHS), policy="Q8",
                                  kv_dtype=kv_dtype, max_new_tokens=SERVE_NEW,
                                  prompt_lengths=SERVE_LENGTHS, seed=0,
                                  device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = len(SERVE_LENGTHS)
    want = q8_launches(layers, summary.decode_steps, n, 0, int8)
    cc = engine.cache_cfg
    log(f"{label}: weights + serve {wall:.1f} s, cache {cc.storage_dtype} "
        f"{cc.cache_nbytes() / 2**20:.1f} MiB; launch counts "
        f"{ {k: v for k, v in counts.items() if v} } (expected "
        f"{ {k: v for k, v in want.items() if v} })")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if summary.requests_done != n or \
            summary.tokens_generated != n * SERVE_NEW:
        raise AssertionError(f"{label}: served {summary.requests_done} "
                             f"requests / {summary.tokens_generated} tokens")
    _all_blocks_back(engine, label)
    if int8:
        _hold_tokens(label, TOKEN_GAP_TOL_Q8, _cache_replay(engine, dev))
    else:
        check_tokens(engine, TOKEN_GAP_TOL_Q8, dev, label)
    log(f"{label}: tokens_per_sec={summary.tokens_per_sec} "
        f"decode_tokens_per_sec={summary.decode_tokens_per_sec} "
        f"ttft_p50_ms={summary.ttft_p50_ms} "
        f"ttft_p99_ms={summary.ttft_p99_ms} "
        f"token_p50_ms={summary.latency_p50_ms} "
        f"token_p99_ms={summary.latency_p99_ms} "
        f"itl_p50_ms={summary.itl_p50_ms} itl_p99_ms={summary.itl_p99_ms} "
        f"decode_steps={summary.decode_steps} wall_s={summary.wall_s} "
        f"digest={engine.tokens_digest()}")
    if int8:
        _float_agreement(engine, dev, label)
    return counts


def _float_agreement(engine, dev, label: str) -> None:
    """The served streams' teacher-forced top-1 agreement with the O5
    float oracle (``gpt_sequence_logits`` on the unquantized weights):
    printed, not held (seeded random weights at this width)."""
    from apex_tpu_torch.serving import init_serving_weights

    weights = init_serving_weights(engine.model_cfg, seed=0, device=dev)
    same = total = 0
    for _, out_tokens, rows in _sequence_oracle(engine, weights, dev):
        want = rows.argmax(dim=-1).tolist()
        same += sum(int(a == b) for a, b in zip(out_tokens, want))
        total += len(out_tokens)
    log(f"{label}: top-1 agreement with the O5 float oracle {same / total:.4f}"
        f" ({same} of {total} positions)")


def serve_q8_legs():
    """The quantized tier's three legs at GPT-345M width, each ``(name,
    fn(dev))`` returning its launch counts: Q8 weights with an int8 cache,
    Q8 alone, and chunked prefill on the int8 cache."""
    from apex_tpu_torch.testing.standalone_gpt import MODELS

    layers = MODELS["gpt345m"]["num_layers"]
    return (("Q8 kv int8", lambda dev: _q8_leg(dev, layers, "int8")),
            ("Q8 kv model", lambda dev: _q8_leg(dev, layers, "model")),
            ("chunked Q8 kv int8", lambda dev: _chunked_leg(
                dev, layers, policy="Q8", kv_dtype="int8")))


# --- phase 3d: MoE serving ----------------------------------------------

def moe_launches(layers: int, ticks: int, prefills: int):
    """Every kernel's launches for an MoE serve of ``ticks`` decode ticks
    and ``prefills`` whole-prompt prefills: row 18 once per MoE layer per
    step."""
    from apex_tpu_torch.ops import KERNELS

    want = {k: 0 for k in KERNELS}
    want.update(layer_norm=(2 * layers + 1) * (ticks + prefills),
                flash_attention=layers * prefills,
                flash_decode=layers * ticks,
                moe_route_dispatch=layers * (ticks + prefills))
    return want


def _moe_serve(dev, cf: float):
    """The serve phase's requests through ``serve_smoke`` with every layer
    an 8-expert MoE at capacity factor ``cf``: ``(summary, engine)``."""
    from apex_tpu_torch.testing.standalone_gpt import serve_smoke

    summary, engine = serve_smoke(len(SERVE_LENGTHS), max_new_tokens=SERVE_NEW,
                                  prompt_lengths=SERVE_LENGTHS, seed=0,
                                  device=dev, moe_experts=MOE_EXPERTS,
                                  moe_capacity_factor=cf)
    torch.cuda.synchronize()
    return summary, engine


def _moe_recorded(dev, cf: float, label: str, digest: str) -> None:
    """The ``cf`` serve again with row 18's wrapper recorded: the drop
    share of every prefill and decode routing call (summed on the device),
    and every ``MOE_SAMPLE_EVERY``-th call of each kind kept with its
    inputs and held against the plain version on them (integers and buf
    exact).  The rerun must serve the same tokens."""
    from apex_tpu_torch.transformer import expert_parallel

    real = expert_parallel._fused
    tally = {kind: [0, torch.zeros((), dtype=torch.long, device=dev), 0]
             for kind in ("prefill", "decode")}
    samples = []

    def recording(x, logits, u, **kw):
        rd = real(x, logits, u, **kw)
        kind = "decode" if x.shape[0] <= 8 else "prefill"
        n, dropped, total = tally[kind]
        tally[kind] = [n + 1, dropped + (~rd.keep).sum(),
                       total + rd.keep.numel()]
        if n % MOE_SAMPLE_EVERY == 0:
            samples.append((kind, n, x.clone(), logits.clone(), kw, rd))
        return rd

    expert_parallel._fused = recording
    try:
        _, engine = _moe_serve(dev, cf)
    finally:
        expert_parallel._fused = real
    if engine.tokens_digest() != digest:
        raise AssertionError(f"{label}: the recorded rerun served other "
                             f"tokens")
    parts = []
    for kind, (n, dropped, total) in tally.items():
        d = int(dropped)
        parts.append(f"{kind} {d} of {total} choices ({100.0 * d / total:.2f}"
                     f"%) in {n} calls")
    log(f"{label}: dropped choices: " + "; ".join(parts))
    worst = 0.0
    with torch.inference_mode():
        for kind, n, x, logits, kw, rd in samples:
            gerr, _ = _route_hold(f"{label} {kind} call {n}", x, logits,
                                  None, kw, rd)
            worst = max(worst, gerr)
    kinds = sorted({s[0] for s in samples})
    if kinds != ["decode", "prefill"]:
        raise AssertionError(f"{label}: samples of {kinds} only")
    log(f"{label}: row 18 on {len(samples)} recorded calls' own (x, logits) "
        f"({', '.join(f'{s[0]} {s[1]} T={s[2].shape[0]} C={s[4]['capacity']}' for s in samples)}) "
        f"against the plain version: expert_index, slot, keep, buf exact, "
        f"gate error {worst:.3e} ok")


def _moe_leg(dev, layers: int, cf: float):
    """One serve_moe leg: a warm-up serve first (on an H100 the cf 8.0
    leg read a token p50 of 24.0 ms run first in its process and 15.4 ms
    after the kernels phase; the warm-up's latencies are printed beside
    the measured serve's), then the measured serve, launch counts reset just
    before it and held exactly, every block back; at
    ``MOE_NODROP_CF`` every token held against the teacher-forced plain
    oracle, below it (drops: the oracle's whole-sequence rows route
    otherwise) the recorded rerun.  Returns the counts."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    label = f"serve_moe cf {cf}"
    warm, _ = _moe_serve(dev, cf)
    log(f"{label}: warm-up serve ttft_p50_ms={warm.ttft_p50_ms} "
        f"token_p50_ms={warm.latency_p50_ms} "
        f"token_p99_ms={warm.latency_p99_ms} wall_s={warm.wall_s}")
    free_memory()
    reset_launch_counts()
    t0 = time.perf_counter()
    summary, engine = _moe_serve(dev, cf)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n = len(SERVE_LENGTHS)
    want = moe_launches(layers, summary.decode_steps, n)
    mc = engine.model_cfg
    n_params = sum(t.numel() for lw in engine.weights.layers for t in lw) \
        + engine.weights.wte.numel() + engine.weights.wpe.numel()
    log(f"{label}: gpt345m width, {layers} layers each a top-1 MoE of "
        f"{mc.num_experts} experts (cf {mc.moe_capacity_factor}), {mc.dtype}, "
        f"{n_params:,} parameters; weights + serve {wall:.1f} s; launch "
        f"counts { {k: v for k, v in counts.items() if v} } (expected "
        f"{ {k: v for k, v in want.items() if v} })")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if summary.requests_done != n or \
            summary.tokens_generated != n * SERVE_NEW:
        raise AssertionError(f"{label}: served {summary.requests_done} "
                             f"requests / {summary.tokens_generated} tokens")
    _all_blocks_back(engine, label)
    log(f"{label}: tokens_per_sec={summary.tokens_per_sec} "
        f"decode_tokens_per_sec={summary.decode_tokens_per_sec} "
        f"ttft_p50_ms={summary.ttft_p50_ms} "
        f"ttft_p99_ms={summary.ttft_p99_ms} "
        f"token_p50_ms={summary.latency_p50_ms} "
        f"token_p99_ms={summary.latency_p99_ms} "
        f"itl_p50_ms={summary.itl_p50_ms} itl_p99_ms={summary.itl_p99_ms} "
        f"decode_steps={summary.decode_steps} wall_s={summary.wall_s} "
        f"digest={engine.tokens_digest()}")
    if cf >= MOE_NODROP_CF:
        check_tokens(engine, TOKEN_GAP_TOL, dev, label)
    else:
        digest = engine.tokens_digest()
        del engine
        free_memory()
        _moe_recorded(dev, cf, label, digest)
    return counts


def serve_moe_legs():
    """The MoE serve's two legs at GPT-345M width, each ``(name,
    fn(dev))`` returning its launch counts."""
    from apex_tpu_torch.testing.standalone_gpt import MODELS

    layers = MODELS["gpt345m"]["num_layers"]
    return tuple((f"cf {cf}", functools.partial(_moe_leg, layers=layers,
                                                cf=cf))
                 for cf in (MOE_NODROP_CF, MOE_DROP_CF))


# the train phases' model families: label and preset
TRAIN_FAMILIES = {"gpt": ("train", "gpt345m"),
                  "gpt_long": ("train_long", "gpt345m_s2048"),
                  "bert": ("train_bert", "bertlarge"),
                  "gpt_dropout": ("train_dropout", "gpt345m"),
                  "gpt_dropout_long": ("train_dropout long",
                                       "gpt345m_s2048")}
# the train_smoke arguments of a family: bench.py's gpt2_345m_dropout
# (bench_gpt345m(dropout=0.1): attention dropout 0.1, hidden 0), and the
# same recipe at seq 2048
TRAIN_KW = {"gpt_dropout": dict(attention_dropout=DROPOUT_RATE),
            "gpt_dropout_long": dict(attention_dropout=DROPOUT_RATE)}


def _train_module(family: str):
    """The train entry module and its full-width preset: GPT-345M (at
    seq 1024, or at seq 2048 for ``gpt_long``) or BERT-large."""
    if family == "bert":
        from apex_tpu_torch.testing import standalone_bert as mod
    else:
        from apex_tpu_torch.testing import standalone_gpt as mod
    return mod, TRAIN_FAMILIES[family][1]


def _train_want(counts, family: str, policy: str, layers: int,
                groups: int):
    """The exact launch counts of ``TRAIN_STEPS`` steps."""
    want = {k: 0 for k in counts}
    # GPT: the stack's 2L + 1 LayerNorms; BERT adds the LM head's
    ln = (2 * layers + (2 if family == "bert" else 1)) * TRAIN_STEPS
    want.update(layer_norm=ln, layer_norm_bwd=ln)
    if family == "gpt" and policy == "O5":
        want.update(flash_attention_e=layers * TRAIN_STEPS,
                    flash_attention_e_bwd=layers * TRAIN_STEPS,
                    fused_adam_pipeline=groups * TRAIN_STEPS)
    elif family == "gpt_long":
        # past a padded length of 1024: the blocked names (rows 11, 13)
        want.update(flash_attention_e_blocked=layers * TRAIN_STEPS,
                    flash_attention_e_bwd_blocked=layers * TRAIN_STEPS,
                    fused_adam_pipeline=groups * TRAIN_STEPS)
    elif family == "gpt_dropout":
        # the dropout lane only: no dropout-free E launch
        want.update(flash_attention_e_dropout=layers * TRAIN_STEPS,
                    flash_attention_e_bwd_dropout=layers * TRAIN_STEPS,
                    fused_adam_pipeline=groups * TRAIN_STEPS)
    elif family == "gpt_dropout_long":
        want.update(flash_attention_e_blocked_dropout=layers * TRAIN_STEPS,
                    flash_attention_e_bwd_blocked_dropout=layers
                    * TRAIN_STEPS,
                    fused_adam_pipeline=groups * TRAIN_STEPS)
    elif family == "gpt":
        want.update(scaled_softmax_causal_fwd=layers * TRAIN_STEPS,
                    scaled_softmax_bwd=layers * TRAIN_STEPS,
                    norm_finite=groups * TRAIN_STEPS,
                    fused_adam_pipeline=groups * TRAIN_STEPS)
    elif policy == "O5":
        # the kv_mask lanes, and LAMB: its global norm by the norm sweep
        # (a static scale checks nothing, so this is the sweep's one use)
        want.update(flash_attention_e_kvmask=layers * TRAIN_STEPS,
                    flash_attention_e_bwd_kvmask=layers * TRAIN_STEPS,
                    norm_finite=groups * TRAIN_STEPS,
                    lamb_phase1=groups * TRAIN_STEPS)
    else:
        want.update(scaled_masked_softmax_fwd=layers * TRAIN_STEPS,
                    scaled_softmax_bwd=layers * TRAIN_STEPS,
                    norm_finite=groups * TRAIN_STEPS,
                    fused_adam_pipeline=groups * TRAIN_STEPS)
    return want


def train_and_check(dev, policy: str = "O5", family: str = "gpt"):
    """The train at full width in ``policy``'s recipe, launch counts
    reset just before.  GPT-345M (O5: flash, bf16, static scale; O2: the
    fused causal softmax, fp16, dynamic scale) or BERT-large on its
    padded batch (O5: the flash kv_mask lane, bf16, fused LAMB; O2: the
    padding-mask softmax, fp16, fused Adam, dynamic scale); GPT-345M with
    attention dropout (``TRAIN_KW``).  Returns ``(counts, losses, steps,
    median step ms)``."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    mod, model = _train_module(family)
    label = f"{TRAIN_FAMILIES[family][0]} {policy}"
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    r = mod.train_smoke(TRAIN_STEPS, model=model, policy=policy, seed=0,
                        device=dev, **TRAIN_KW.get(family, {}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    geo = mod.MODELS[model]
    layers = geo["num_layers"]
    if not r.setup.amp_opt.use_pipeline:
        raise AssertionError(f"{label} did not take the persistent "
                             f"pipeline")
    groups = len(r.setup.amp_opt.groups)
    gdtypes = "/".join(str(g.dtype).replace("torch.", "")
                       for g in r.setup.amp_opt.groups)
    want = _train_want(counts, family, policy, layers, groups)
    padded = ""
    if family == "bert":
        real = int(r.setup.mask.sum())
        padded = (f", {real} of {r.setup.mask.numel()} tokens real (row "
                  f"lengths {r.setup.mask.sum(-1).tolist()})")
    log(f"{label}: {model} (vocab {geo['vocab_size']}, hidden "
        f"{geo['hidden_size']}, {layers} layers, {geo['num_heads']} heads), "
        f"seq {geo['seq']} batch {geo['batch']}{padded}, "
        f"{r.setup.n_params} params in {groups} pipeline group(s) "
        f"({gdtypes}), "
        f"{TRAIN_STEPS} steps (setup + steps {wall:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB)")
    log(f"{label}: launch counts {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    losses = r.losses
    log(f"{label}: losses {[round(x, 6) for x in losses]}")
    if policy != "O5":
        for i, (loss, (fin, scale, skipped, gnorm)) in enumerate(
                zip(losses, r.steps)):
            log(f"  step {i + 1}: loss {loss:.6f} finite {fin} scale "
                f"{scale:g} skipped {skipped} grad_norm {gnorm!r}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if family == "bert" and policy == "O5":
        # LAMB's clip reads the global norm on the device: one more step
        # (after the counts were taken) with PyTorch's sync check raising
        # on any host wait
        torch.cuda.set_sync_debug_mode("error")
        try:
            mod.train_step(r.setup)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log(f"{label}: a step under torch.cuda.set_sync_debug_mode('error') "
            f"made no host synchronisation")
    _log_speed(label, r, policy)
    steps, median = r.steps, r.median_ms
    del r
    free_memory()
    return counts, losses, steps, median


def _log_speed(label: str, r, policy: str) -> None:
    """A train run's step ms, tokens/s (over every position, and over
    the real ones for BERT) and model TFLOP/s."""
    peak = BF16_FLOPS / 1e12
    dt = "bf16" if policy == "O5" else "fp16"
    real = getattr(r.setup, "real_tokens", None)
    real_s = "" if real is None else \
        f" ({real / (r.median_ms / 1e3):.1f} over the {real} real tokens)"
    log(f"{label}: step ms {[round(x, 3) for x in r.step_ms]}; "
        f"median of steps 3-{len(r.step_ms)} {r.median_ms:.3f} ms, tokens/s "
        f"{r.tokens_per_sec:.1f}{real_s}, model TFLOP/s "
        f"{r.tflops_per_sec:.3f} ({r.setup.flops_per_step / 1e12:.3f} "
        f"TFLOP a step, {100 * r.tflops_per_sec / peak:.2f}% of the "
        f"{peak:.0f} TFLOP/s {dt} dense peak, so no step could take under "
        f"{r.setup.flops_per_step / BF16_FLOPS * 1e3:.2f} ms)")


def train_bert_full_mask(dev, policy: str):
    """BERT-large in ``policy``'s recipe on bench.py's own batch, the
    all-ones mask of ``bench_bert_large`` (every token real, every key
    tile live): ``TRAIN_STEPS`` steps timed for the speed figures, the
    same kernels launched the same exact number of times as on the
    padded batch, every loss finite."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    mod, model = _train_module("bert")
    label = f"train_bert {policy} all-ones mask"
    reset_launch_counts()
    r = mod.train_smoke(TRAIN_STEPS, model=model, policy=policy, seed=0,
                        full_mask=True, device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = _train_want(counts, "bert", policy,
                       mod.MODELS[model]["num_layers"],
                       len(r.setup.amp_opt.groups))
    log(f"{label}: {r.setup.real_tokens} of {r.setup.mask.numel()} tokens "
        f"real; launch counts {counts} (expected {want}); losses "
        f"{[round(x, 6) for x in r.losses]}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not all(math.isfinite(x) for x in r.losses):
        raise AssertionError(f"losses not finite: {r.losses}")
    _log_speed(label, r, policy)
    del r
    free_memory()


def train_plain_and_compare(dev, kernel_losses, policy: str = "O5",
                            kernel_steps=None, family: str = "gpt"):
    """The first steps again through the plain versions (no kernel may
    launch), each loss held against the kernel run's; under a dynamic
    scale the (finite, scale, skipped) sequence must equal it too.  The
    O5 GPT and BERT families (``SEEDED_FAMILIES``) hold the median over
    ``TRAIN_SEEDS`` of each step's gap instead, the first seed's kernel
    losses the train run's."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    mod, model = _train_module(family)
    tol = {("gpt", "O5"): TRAIN_LOSS_TOL, ("gpt", "O2"): TRAIN_O2_LOSS_TOL,
           ("gpt_long", "O5"): TRAIN_LONG_LOSS_TOL,
           ("bert", "O5"): TRAIN_BERT_LOSS_TOL,
           ("bert", "O2"): TRAIN_BERT_O2_LOSS_TOL,
           ("gpt_dropout", "O5"): TRAIN_DROPOUT_LOSS_TOL}[family, policy]
    seeded = policy == "O5" and family in SEEDED_FAMILIES
    reset_launch_counts()
    t0 = time.perf_counter()
    r = mod.train_smoke(PLAIN_STEPS, model=model, policy=policy,
                        seed=0, kernels=False, device=dev,
                        **TRAIN_KW.get(family, {}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    diffs = [abs(a - b) for a, b in zip(r.losses, kernel_losses)]
    tols = tuple(tol) if isinstance(tol, tuple) else (tol,) * PLAIN_STEPS
    seq = [x[:3] for x in r.steps]
    want_seq = [x[:3] for x in kernel_steps] if kernel_steps else seq
    label = f"{TRAIN_FAMILIES[family][0]} {policy} plain"
    log(f"{label}: {PLAIN_STEPS} steps through the plain "
        f"versions ({wall:.1f} s, median step {r.median_ms:.3f} ms): "
        f"losses {[round(x, 6) for x in r.losses]}, |kernel - plain| "
        f"{[f'{x:.2e}' for x in diffs]} (tol {tol}); (finite, scale, "
        f"skipped) {seq}; launches {sum(counts.values())}")
    del r
    free_memory()
    if any(counts.values()):
        raise AssertionError(f"the plain run launched kernels: {counts}")
    if seq != want_seq:
        raise AssertionError(f"plain skip sequence {seq} != the kernel "
                             f"run's {want_seq}")
    if seeded:
        gaps = [diffs]
        for seed in TRAIN_SEEDS[1:]:
            pair = [_spread_losses(dev, family, seed, forward)
                    for forward in ("kernel", "plain")]
            free_memory()
            gaps.append([abs(a - b) for a, b in zip(*pair)])
            log(f"{label}: seed {seed} |kernel - plain| "
                f"{[f'{x:.2e}' for x in gaps[-1]]}")
        diffs = [float(np.median([g[i] for g in gaps]))
                 for i in range(PLAIN_STEPS)]
        log(f"{label}: the median over seeds {list(TRAIN_SEEDS)} of each "
            f"step's |kernel - plain| {[f'{x:.2e}' for x in diffs]} (tol "
            f"{tol})")
    if len(diffs) != PLAIN_STEPS or any(d > t for d, t in zip(diffs, tols)):
        raise AssertionError(f"plain losses differ: {diffs} (tol {tol})")
    return diffs


def overflow_leg(dev):
    """O2 with kernels from a loss scale of 2^40: step until the first
    applied step (at most ``OVERFLOW_MAX_STEPS``).  Every skipped step
    must leave masters, moments, the fp16 parameters and the Adam count
    bitwise as they were (``torch.equal`` on the device against clones
    taken before the step); the scale runs 2^24 (the backoff clipped),
    then halves; the first applied step moves the masters."""
    import dataclasses

    from apex_tpu_torch.testing.standalone_gpt import (make_train_setup,
                                                       train_step)

    setup = make_train_setup("gpt345m", policy="O2", seed=0, device=dev)
    aopt = setup.amp_opt
    aopt.scaler = dataclasses.replace(aopt.scaler,
                                      loss_scale=OVERFLOW_SCALE)
    t0 = time.perf_counter()
    rows, applied = [], False
    for step in range(1, OVERFLOW_MAX_STEPS + 1):
        before = [t.clone() for g in aopt.groups
                  for t in (g.master, g.data)] + \
            [t.clone() for t in (*aopt.state.m, *aopt.state.v)]
        count = aopt.state.count
        loss, info = train_step(setup)
        after = [t for g in aopt.groups for t in (g.master, g.data)] + \
            [*aopt.state.m, *aopt.state.v]
        held = all(torch.equal(a, b) for a, b in zip(before, after)) and \
            aopt.state.count == count
        moved = not torch.equal(before[0], after[0])
        del before
        rows.append((step, float(loss), info.grads_finite, info.loss_scale,
                     info.steps_skipped, info.grad_norm, held))
        log(f"  overflow step {step}: loss {float(loss):.6f} finite "
            f"{info.grads_finite} scale {info.loss_scale:g} skipped "
            f"{info.steps_skipped} grad_norm {info.grad_norm!r} state held "
            f"bitwise {held} masters moved {moved}")
        if info.grads_finite:
            applied = True
            if not moved or aopt.state.count != count + 1:
                raise AssertionError("the first applied step did not move "
                                     "the masters and the count")
            break
        if not held:
            raise AssertionError(f"skipped step {step} changed the state")
        want = min(OVERFLOW_SCALE, 2.0 ** 25) * 0.5 ** step
        if info.loss_scale != want or info.steps_skipped != step:
            raise AssertionError(f"step {step}: scale {info.loss_scale}, "
                                 f"skipped {info.steps_skipped}; want "
                                 f"{want}, {step}")
    torch.cuda.synchronize()
    skips = sum(1 for r in rows if not r[2])
    log(f"train O2 overflow leg: {skips} skipped step(s) from 2^40, then "
        f"{'an applied step' if applied else 'no applied step'} at scale "
        f"{rows[-1][3]:g} ({time.perf_counter() - t0:.1f} s)")
    del setup, aopt
    free_memory()
    if not applied:
        raise AssertionError(f"no applied step within "
                             f"{OVERFLOW_MAX_STEPS} steps from 2^40")


# --- phase 6f, the ResNet-50 train step ---------------------------------

def _resnet_setup(dev, **kw):
    """bench_resnet50's ResNet-50 from seed 0 through the port's ``main_amp``:
    batch 256 (unless ``batch`` says otherwise), 224x224, 1000 classes,
    O5 and fused_sgd(0.1, momentum=0.9, weight_decay=1e-4) unless ``kw``
    says otherwise."""
    from apex_tpu_torch.examples.imagenet import main_amp

    kw.setdefault("batch", RESNET_BATCH)
    return main_amp.make_train_setup(
        "resnet50", image_size=RESNET_IMAGE, num_classes=RESNET_CLASSES,
        seed=0, device=dev, **kw)


def _resnet_run(dev, label, steps, want, **kw):
    """A fresh seeded setup, then ``steps`` steps on its batch with the
    launch counts reset just before and held to ``want(result)`` (every
    other count 0); losses finite.  Returns ``(result, counts)``."""
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    setup = _resnet_setup(dev, **kw)
    torch.cuda.synchronize()
    reset_launch_counts()
    r = main_amp.run_steps(setup, steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect = {k: 0 for k in counts}
    expect.update(want(r))
    route = "pipeline" if setup.amp_opt.use_pipeline else "staged"
    log(f"train_resnet {label}: route {route}, launch counts "
        f"{ {k: v for k, v in counts.items() if v} } (expected "
        f"{ {k: v for k, v in expect.items() if v} }); losses "
        f"{[round(x, 6) for x in r.losses]}")
    if counts != expect:
        raise AssertionError(f"{label}: launch counts {counts} != {expect}")
    if not all(math.isfinite(x) for x in r.losses):
        raise AssertionError(f"{label}: losses not finite: {r.losses}")
    return r, counts


def _masters(r) -> dict:
    return {k: v.detach().clone() for k, v in
            r.setup.amp_opt.masters().items()}


def _max_diff(a: dict, b: dict) -> float:
    return max(max_err(a[k], b[k]) for k in a)


def _add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in counts.items()}


def _resnet_same_grads(dev) -> None:
    """One staged and one pipeline optimizer from the same weights, two
    steps, the pipeline fed the staged run's captured gradients: the
    masters, momenta and model copies must be equal bit for bit (the
    same math, the scale 1 multiply exact)."""
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss

    st = _resnet_setup(dev)
    pp = _resnet_setup(dev, pipeline=True)
    assert not st.amp_opt.use_pipeline and pp.amp_opt.use_pipeline
    pnamed = dict(pp.model.named_parameters())
    for step in range(2):
        st.amp_opt.zero_grad()
        loss = softmax_cross_entropy_loss(
            st.model(st.images, train=True), st.labels,
            half_to_float=True).mean()
        st.amp_opt.scale_loss(loss).backward()
        grads = {n: p.grad.clone() for n, p in st.model.named_parameters()}
        st.amp_opt.apply_gradients()
        pp.amp_opt.zero_grad()
        for n, gr in grads.items():
            pnamed[n].grad.copy_(gr)
        pp.amp_opt.apply_gradients()
        torch.cuda.synchronize()
        ms, mp = st.amp_opt.masters(), pp.amp_opt.masters()
        mom_s = {n: m for (n, _), m in zip(st.amp_opt.params,
                                            st.amp_opt.state.momentum)}
        mom_p = {n: grp_m[o:o + p.numel()].view(p.shape)
                 for grp, grp_m in zip(pp.amp_opt.groups,
                                       pp.amp_opt.state.momentum)
                 for n, p, o in zip(grp.names, grp.params, grp.offsets)}
        same = (all(torch.equal(ms[n], mp[n]) for n in ms)
                and all(torch.equal(mom_s[n], mom_p[n]) for n in mom_s)
                and all(torch.equal(p, pnamed[n])
                        for n, p in st.model.named_parameters()))
        log(f"train_resnet same gradients, step {step + 1}: staged "
            f"({staged_launches(st.amp_opt)} sgd_step launches) and "
            f"pipeline (2 sgd_pipeline "
            f"launches) masters, momenta and model copies bitwise equal: "
            f"{same} (max |master diff| {_max_diff(ms, mp):.3e}) "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("staged and pipeline steps differ on the "
                                 "same gradients")
    del st, pp
    free_memory()


def _resnet_eval(dev) -> None:
    """The graft entry's eval forward: batch 8, ``train=False`` (the
    running averages of a fresh model), bf16, against the same weights
    in fp32 compute (TF32 off)."""
    setup = _resnet_setup(dev, batch=RESNET_EVAL_BATCH)
    m = setup.model
    with torch.no_grad():
        lo = m(setup.images, train=False)
        m.dtype = torch.float32
        ref = m(setup.images.float(), train=False)
        m.dtype = torch.bfloat16
    rel = rel_err(lo, ref)
    ok = lo.shape == (RESNET_EVAL_BATCH, RESNET_CLASSES) and \
        bool(torch.isfinite(lo).all()) and rel <= RESNET_EVAL_RTOL
    log(f"train_resnet eval: batch {RESNET_EVAL_BATCH} train=False logits "
        f"{tuple(lo.shape)} finite, bf16 against fp32 compute on the same "
        f"weights: max |err| {max_err(lo, ref):.4e} = {rel:.3e} of max "
        f"|logit| {float(ref.abs().max()):.4f} (tol {RESNET_EVAL_RTOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the eval forward disagrees")
    del setup
    free_memory()


def train_resnet(dev) -> dict:
    """bench_resnet50's train step through the port's ``main_amp``:
    the routed default (staged) and the pipeline route timed, the plain,
    deterministic pipeline, Adam and O2 legs, the same-gradient comparison
    and the eval forward.  Returns the path's launch counts summed over
    the legs."""
    from apex_tpu_torch import amp

    torch.cuda.reset_peak_memory_stats(dev)
    r, total = _resnet_run(
        dev, "staged O5", RESNET_STEPS,
        lambda r: {"sgd_step": staged_launches(r.setup.amp_opt)
                   * RESNET_STEPS})
    aopt = r.setup.amp_opt
    nbytes = amp.packed_nbytes(r.setup.model.named_parameters(),
                               amp.get_policy("O5"))
    if aopt.use_pipeline or len(aopt.params) != RESNET_LEAVES:
        raise AssertionError("ResNet-50 did not take the staged route")
    if not r.losses[-1] < r.losses[0]:
        raise AssertionError(f"losses not falling: {r.losses}")
    med, host = r.median_ms, r.opt_median_ms
    tf = r.tflops_per_sec
    peak = BF16_FLOPS / 1e12
    log(f"train_resnet staged O5: ResNet-50, batch {RESNET_BATCH}, "
        f"{RESNET_IMAGE}x{RESNET_IMAGE}, {r.setup.n_params} params in "
        f"{len(aopt.params)} leaves, cast model {nbytes} bytes < "
        f"{amp.PIPELINE_PACK_MIN_BYTES} (the routed default: staged), "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        f"GiB")
    log(f"train_resnet staged O5: step ms {[round(x, 3) for x in r.step_ms]};"
        f" median of steps 3-{RESNET_STEPS} {med:.3f} ms, images/s "
        f"{r.images_per_sec:.1f}, model TFLOP/s {tf:.3f} "
        f"({r.setup.flops_per_step / 1e12:.4f} TFLOP a step at bench.py's "
        f"3 x 4.1 GFLOP an image, {100 * tf / peak:.2f}% of the "
        f"{peak:.0f} TFLOP/s bf16 dense peak); the optimizer step's host "
        f"time {host:.3f} ms ({[round(x, 3) for x in r.opt_ms]}), "
        f"{100 * host / med:.2f}% of the step ({staged_launches(aopt)} "
        f"ctypes launches over {RESNET_LEAVES} leaves)")
    del r, aopt
    free_memory()
    # the same step on the other route, timed alike, for the routing
    # cutoff's cost on this card
    rt, ct = _resnet_run(
        dev, "pipeline=True O5, timed", RESNET_STEPS,
        lambda r: {"sgd_pipeline": 2 * RESNET_STEPS}, pipeline=True)
    log(f"train_resnet pipeline=True O5: step ms "
        f"{[round(x, 3) for x in rt.step_ms]}; median of steps "
        f"3-{RESNET_STEPS} {rt.median_ms:.3f} ms ({rt.median_ms - med:+.3f}"
        f" ms against the staged route), images/s "
        f"{rt.images_per_sec:.1f}; the optimizer step's host time "
        f"{rt.opt_median_ms:.3f} ms (2 ctypes launches)")
    total = _add_counts(total, ct)
    del rt
    free_memory()
    # the plain and pipeline legs against a kernel run, all on cuDNN's
    # deterministic algorithms: the optimizer kernels equal their plain
    # versions bit for bit, so the runs may differ only by a fault
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rk, ck = _resnet_run(
            dev, "staged O5, deterministic cuDNN", PLAIN_STEPS,
            lambda r: {"sgd_step": staged_launches(r.setup.amp_opt)
                       * PLAIN_STEPS})
        kl, km = rk.losses, _masters(rk)
        del rk
        free_memory()
        rp, _ = _resnet_run(dev, "plain", PLAIN_STEPS, lambda r: {},
                            kernels=False)
        pl, pm = rp.losses, _masters(rp)
        del rp
        free_memory()
        rq, cq = _resnet_run(dev, "pipeline=True", PLAIN_STEPS,
                             lambda r: {"sgd_pipeline": 2 * PLAIN_STEPS},
                             pipeline=True)
        if len(rq.setup.amp_opt.groups) != 2:
            raise AssertionError("the pipeline leg is not 2 groups")
        ql, qm = rq.losses, _masters(rq)
        del rq
        free_memory()
    finally:
        torch.backends.cudnn.deterministic = prev
    total = _add_counts(_add_counts(total, ck), cq)
    for what, losses, masters in (("plain", pl, pm), ("pipeline", ql, qm)):
        diffs = [abs(a - b) for a, b in zip(losses, kl)]
        log(f"train_resnet {what} vs staged kernels: |loss diff| "
            f"{[f'{x:.2e}' for x in diffs]} (tol {TRAIN_RESNET_LOSS_TOL}); "
            f"max |master diff| after {PLAIN_STEPS} steps "
            f"{_max_diff(km, masters):.3e}")
        if any(d > t for d, t in zip(diffs, TRAIN_RESNET_LOSS_TOL)):
            raise AssertionError(f"{what} losses differ: {diffs}")
    del km, pm, qm
    _resnet_same_grads(dev)
    ra, ca = _resnet_run(
        dev, f"Adam (fused_adam({RESNET_ADAM_LR}, weight_decay=1e-4))",
        RESNET_ADAM_STEPS,
        lambda r: {"adam_step": staged_launches(r.setup.amp_opt,
                                                "fused_adam")
                   * RESNET_ADAM_STEPS},
        optimizer="adam", lr=RESNET_ADAM_LR)
    del ra
    free_memory()
    ro, co = _resnet_run(
        dev, "O2 (fp16 convs, fp32 batch norm, dynamic scale)",
        RESNET_O2_STEPS,
        lambda r: {"sgd_step": staged_launches(r.setup.amp_opt)
                   * sum(1 for f, _, _ in r.steps if f)}, opt_level="O2")
    for i, (fin, scale, skipped) in enumerate(ro.steps):
        log(f"  O2 step {i + 1}: loss {ro.losses[i]:.6f} finite {fin} "
            f"scale {scale:g} skipped {skipped} step ms "
            f"{ro.step_ms[i]:.3f}")
    del ro
    free_memory()
    total = _add_counts(_add_counts(total, ca), co)
    _resnet_eval(dev)
    return total


# run in a copy of the port with a planted fault: 3 kernel and 3 plain
# steps on deterministic cuDNN, one JSON line of the loss differences
_FAULT_LEG = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
n = cs.PLAIN_STEPS
rk, _ = cs._resnet_run(dev, "fault kernel", n,
                       lambda r: {"sgd_step":
                                  cs.staged_launches(r.setup.amp_opt) * n})
kl, km = rk.losses, cs._masters(rk)
del rk
cs.free_memory()
rp, _ = cs._resnet_run(dev, "fault plain", n, lambda r: {}, kernels=False)
print("FAULT " + json.dumps({
    "diffs": [abs(a - b) for a, b in zip(kl, rp.losses)],
    "master": cs._max_diff(km, cs._masters(rp))}), flush=True)
"""


def resnet_faults(dev) -> None:
    """Each fault of ``RESNET_FAULTS`` planted in a temporary copy of the
    port (``fused_sgd.cu`` edited, built afresh there), then the
    deterministic kernel-against-plain leg of ``train_resnet`` in that
    copy: every fault must move a loss past ``TRAIN_RESNET_LOSS_TOL``."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        for name, (sound, faulty) in RESNET_FAULTS.items():
            d = Path(tmp) / name
            shutil.copytree(root / "apex_tpu_torch", d / "apex_tpu_torch",
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(root / "chip_smoke.py", d)
            src = d / "apex_tpu_torch" / "csrc" / "fused_sgd.cu"
            text = src.read_text()
            if sound not in text:
                raise AssertionError(f"fault {name}: {sound!r} not found")
            src.write_text(text.replace(sound, faulty))
            out = subprocess.run([sys.executable, "-c", _FAULT_LEG], cwd=d,
                                 capture_output=True, text=True, timeout=900)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("FAULT ")]
            if out.returncode != 0 or not lines:
                raise AssertionError(f"fault {name}: the leg failed "
                                     f"({out.returncode}):\n"
                                     f"{out.stderr[-3000:]}")
            r = json.loads(lines[-1][len("FAULT "):])
            caught = any(x > t for x, t in zip(r["diffs"],
                                               TRAIN_RESNET_LOSS_TOL))
            log(f"resnet_faults {name} ({faulty.strip()}): |kernel - plain| "
                f"losses {[f'{x:.3e}' for x in r['diffs']]} (tol "
                f"{TRAIN_RESNET_LOSS_TOL}), max |master diff| "
                f"{r['master']:.3e}: caught {caught} "
                f"{'ok' if caught else 'FAIL'}")
            if not caught:
                raise AssertionError(f"fault {name} passed the loss limit")


# run in a copy of the port with a planted dropout fault: the keep masks
# read back at DROPOUT_READBACK, then 3 kernel and 3 plain steps of
# train_dropout; one JSON line of the mismatches and the loss differences
_DROPOUT_FAULT_LEG = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from apex_tpu_torch import _build
from apex_tpu_torch.ops import e_mode, rand_keep
from apex_tpu_torch.testing import standalone_gpt
_build.build()
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
seed, rate = cs.DROPOUT_READBACK_SEED, cs.DROPOUT_RATE
wrong = []
for b, s, h, d in cs.DROPOUT_READBACK:
    want = rand_keep(b, h, s, s, seed, rate, e_mode(s, h, d, drop=True),
                     device=dev)
    wrong.append([int((m != want).sum())
                  for m in cs._readback_keep(dev, b, s, h, d, seed)])
    del want
    cs.free_memory()
n, kw = cs.PLAIN_STEPS, cs.TRAIN_KW["gpt_dropout"]
kl = standalone_gpt.train_smoke(n, seed=0, device=dev, **kw).losses
cs.free_memory()
pl = standalone_gpt.train_smoke(n, seed=0, kernels=False, device=dev,
                                **kw).losses
print("FAULT " + json.dumps({
    "wrong": wrong, "diffs": [abs(a - b) for a, b in zip(kl, pl)]}),
    flush=True)
"""


def dropout_faults(dev) -> None:
    """Each fault of ``DROPOUT_FAULTS`` planted in a temporary copy of the
    port (its built libraries copied, the edited source rebuilt there),
    then the keep-mask readback and 3 kernel and 3 plain steps of
    ``train_dropout`` in that copy: each fault must be caught, by a
    readback mismatch or a loss past ``TRAIN_DROPOUT_LOSS_TOL``; which
    one catches it is printed."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        for name, (source, *edits) in DROPOUT_FAULTS.items():
            d = Path(tmp) / name
            shutil.copytree(root / "apex_tpu_torch", d / "apex_tpu_torch",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(root / "chip_smoke.py", d)
            src = d / "apex_tpu_torch" / "csrc" / source
            text = src.read_text()
            for sound, faulty in zip(edits[::2], edits[1::2]):
                if sound not in text:
                    raise AssertionError(f"fault {name}: {sound!r} not "
                                         f"found")
                text = text.replace(sound, faulty)
            src.write_text(text)
            out = subprocess.run([sys.executable, "-c", _DROPOUT_FAULT_LEG],
                                 cwd=d, capture_output=True, text=True,
                                 timeout=900)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("FAULT ")]
            if out.returncode != 0 or not lines:
                raise AssertionError(f"fault {name}: the leg failed "
                                     f"({out.returncode}):\n"
                                     f"{out.stderr[-3000:]}")
            r = json.loads(lines[-1][len("FAULT "):])
            by_loss = any(x > t for x, t in zip(r["diffs"],
                                                TRAIN_DROPOUT_LOSS_TOL))
            by_readback = any(any(w) for w in r["wrong"])
            log(f"dropout_faults {name} ({' / '.join(edits[1::2])}): keep "
                f"pairs that differ (forward, dQ, dK/dV) per readback shape "
                f"{r['wrong']}; train_dropout |kernel - plain| losses "
                f"{[f'{x:.3e}' for x in r['diffs']]} (tol "
                f"{TRAIN_DROPOUT_LOSS_TOL}): caught by the readback "
                f"{by_readback}, by the loss limit {by_loss} "
                f"{'ok' if by_loss or by_readback else 'FAIL'}")
            if not (by_loss or by_readback):
                raise AssertionError(f"fault {name} was not caught")


# --- phase 6g, Megatron's BERT-large pretraining recipe -----------------

class _TracedSchedule:
    """A learning-rate schedule that records each ``(count, lr)`` the
    optimizer asks it for: the trace of the rate a step used."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, count):
        lr = self.fn(count)
        self.calls.append((int(count), lr))
        return lr


class _ClipTrace:
    """Records every ``(norm, factor)`` the optimizers' clip computes
    (``_grad_clip_factor`` in the LAMB modules, wrapped while the trace
    is open); the device scalars are read once, after the run."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        # the modules (the package exports fused_lamb, the function)
        self.mods = tuple(importlib.import_module(
            f"apex_tpu_torch.optimizers.{m}") for m in
            ("fused_lamb", "fused_mixed_precision_lamb"))
        self.orig = self.mods[0]._grad_clip_factor

        def traced(gnorm, max_norm):
            clip = self.orig(gnorm, max_norm)
            self.rows.append((gnorm, clip, max_norm))
            return clip

        for m in self.mods:
            m._grad_clip_factor = traced
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m._grad_clip_factor = self.orig

    def read(self):
        return [(float(n), float(c), float(mx)) for n, c, mx in self.rows]


def recipe_args():
    from apex_tpu_torch.testing.arguments import parse_args
    return parse_args(args=list(RECIPE_ARGV))


def recipe_lr(args):
    """The recipe's rate as a plain function of the optimizer's count:
    linear warmup over ``RECIPE_WARMUP`` steps to ``--lr``, then linear
    decay to 0 at ``--lr-decay-iters``."""
    peak, warm, end = args.lr, RECIPE_WARMUP, args.lr_decay_iters

    def lr(count):
        if count <= warm:
            return peak * count / warm
        return peak * max(0.0, (end - count) / (end - warm))
    return lr


def _recipe_batch(dev, args, seed: int):
    """One padded batch from ``seed``: tokens, the (b, s) mask (a quarter
    of the rows full), labels = tokens rolled by one, NSP labels."""
    from apex_tpu_torch.testing.standalone_bert import padded_mask

    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    b, s = args.micro_batch_size, args.seq_length
    tokens = torch.randint(0, args.vocab_size, (b, s), generator=g,
                           device=dev)
    mask = padded_mask(b, s, g, device=dev)
    nsp = torch.randint(0, 2, (b,), generator=g, device=dev)
    return tokens, mask, torch.roll(tokens, -1, dims=-1), nsp


def recipe_setup(dev, *, seed: int = 0, checkpoint: bool = True,
                 use_flash: bool = False, pipeline: bool = False,
                 kernels: bool = True):
    """BERT-large from ``RECIPE_ARGV`` through ``bert_model_provider``
    (weights from ``--seed`` plus ``seed``; checkpointing as the args
    say unless ``checkpoint`` is False; ``use_flash`` through the
    provider's overrides), ``fused_lamb`` on the recipe's schedule with
    ``--weight-decay`` and ``--clip-grad``, ``amp.initialize`` at O5 on
    the staged route (``pipeline=False``) or the pipeline, one padded
    batch from ``seed`` and a DropoutRNG from ``seed + 1``.  Returns the
    ``BertTrainSetup`` and the traced schedule."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.testing import standalone_bert as sb
    from apex_tpu_torch.transformer import DropoutRNG

    args = recipe_args()
    args.seed += seed
    net = sb.bert_model_provider(
        args, device=dev, num_tokentypes=0, use_flash=use_flash,
        kernels=kernels,
        checkpoint_activations=args.checkpoint_activations and checkpoint)
    n_params = sum(p.numel() for p in net.parameters())
    sched = _TracedSchedule(recipe_lr(args))
    opt = fused_lamb(sched, weight_decay=args.weight_decay,
                     max_grad_norm=args.clip_grad, kernels=kernels)
    net, aopt = amp.initialize(net, opt, opt_level="O5", pipeline=pipeline)
    tokens, mask, labels, nsp = _recipe_batch(dev, args, seed)
    flops = sb.bert_model_flops(n_params, args.num_layers, args.hidden_size,
                                mask)
    return sb.BertTrainSetup(net, aopt, tokens, mask, labels, nsp, n_params,
                             flops, int(mask.sum()),
                             DropoutRNG(seed + 1, dev)), sched


def recipe_run(setup, steps: int):
    """``steps`` train steps; the losses and each step's wall ms through
    the read of its loss."""
    from apex_tpu_torch.testing.standalone_bert import train_step

    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _ = train_step(setup)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def recipe_pair_losses(dev, steps: int, use_flash: bool = False):
    """The staged recipe's losses with checkpointing on, then off, from
    one seed (leg a's pair; the planted fault's leg runs it too)."""
    out = []
    for ckpt in (True, False):
        setup, _ = recipe_setup(dev, checkpoint=ckpt, use_flash=use_flash)
        out.append(recipe_run(setup, steps)[0])
        del setup
        free_memory()
    return out


def _recipe_want(counts, layers: int, steps: int, *, ckpt: bool,
                 use_flash: bool, phase1: int, groups: int = 0):
    """The exact launch counts of ``steps`` recipe steps: the layers'
    forwards run twice under checkpointing (the recompute), the LM
    head's and the final LayerNorm once; ``phase1`` LAMB phase-1
    launches a step (a leaf each staged, a group each on the pipeline,
    whose static scale takes the norm sweep a group)."""
    want = {k: 0 for k in counts}
    runs = 2 if ckpt else 1
    want.update(layer_norm=(2 * layers * runs + 2) * steps,
                layer_norm_bwd=(2 * layers + 2) * steps,
                lamb_phase1=phase1 * steps)
    if use_flash:
        want.update(flash_attention_e_dropout=layers * runs * steps,
                    flash_attention_e_bwd_dropout=layers * steps)
    else:
        want.update(scaled_masked_softmax_fwd=layers * runs * steps,
                    scaled_softmax_bwd=layers * steps)
    if groups:
        want.update(norm_finite=groups * steps)
    return want


def _recipe_trace(label, sched, trace, steps: int, args) -> None:
    """Leg e: each step's rate against the schedule at JAX's count
    (``count + 1``: the step's number, every step finite), its clip
    factor against ``min(1, clip / norm)``, the unscaled norm; at least
    one step must clip."""
    lr = recipe_lr(args)
    rows = trace.read()
    calls = sched.calls
    if len(rows) != steps or len(calls) != steps:
        raise AssertionError(f"{label}: {len(calls)} rate reads and "
                             f"{len(rows)} clips over {steps} steps")
    clipped = 0
    for i, ((count, used), (norm, clip, mx)) in enumerate(zip(calls, rows)):
        want = float(np.float32(mx) / max(np.float32(norm),
                                          np.float32(1e-12))) \
            if norm > mx else 1.0
        log(f"  {label} step {i + 1}: lr {used:.6e} at count {count} (the "
            f"function at JAX's count {i + 1}: {lr(i + 1):.6e}); unscaled "
            f"norm {norm:.6f}, clip factor {clip:.6f} (bound {mx:g})")
        if count != i + 1 or used != lr(i + 1):
            raise AssertionError(f"{label} step {i + 1}: the rate was read "
                                 f"at count {count}, {used}")
        if not (math.isfinite(norm) and abs(clip - want) <= 1e-6 * want):
            raise AssertionError(f"{label} step {i + 1}: clip {clip} for "
                                 f"norm {norm}, want {want}")
        clipped += clip < 1.0
    if not clipped:
        raise AssertionError(f"{label}: no step clipped")


def _recipe_leg(dev, label, *, use_flash: bool, pipeline: bool = False,
                ckpt: bool = True, trace: bool = False):
    """One counted run of ``RECIPE_STEPS``: losses finite and falling,
    launch counts exact, peak memory and the step median printed."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    setup, sched = recipe_setup(dev, checkpoint=ckpt, use_flash=use_flash,
                                pipeline=pipeline)
    with _ClipTrace() as clips:
        losses, ms = recipe_run(setup, RECIPE_STEPS)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    args = recipe_args()
    aopt = setup.amp_opt
    if aopt.use_pipeline != pipeline:
        raise AssertionError(f"{label}: took the "
                             f"{'pipeline' if aopt.use_pipeline else 'staged'}"
                             f" route")
    groups = len(aopt.groups) if pipeline else 0
    want = _recipe_want(counts, args.num_layers, RECIPE_STEPS, ckpt=ckpt,
                        use_flash=use_flash,
                        phase1=groups or len(aopt.params), groups=groups)
    median = float(np.median(ms[2:]))
    log(f"{label}: {setup.n_params} params, {setup.real_tokens} of "
        f"{setup.mask.numel()} tokens real, checkpointing "
        f"{'on' if ckpt else 'off'}; losses {[round(x, 6) for x in losses]};"
        f" step ms {[round(x, 3) for x in ms]} (median of steps 3-"
        f"{RECIPE_STEPS} {median:.3f}); peak memory {peak:.3f} GiB")
    log(f"{label}: launch counts { {k: v for k, v in counts.items() if v} }"
        f" (expected { {k: v for k, v in want.items() if v} })")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses not finite and falling")
    if trace:
        _recipe_trace(label, sched, clips, RECIPE_STEPS, args)
    del setup, aopt
    free_memory()
    return counts, losses, median, peak


def _recipe_hold_pair(label, on, off, spread=None) -> None:
    """Leg a/b's hold: the checkpointed run's losses the uncheckpointed
    run's bit for bit; where two uncheckpointed runs differ (``spread``,
    their per-step gap), within that spread instead."""
    gaps = [abs(a - b) for a, b in zip(on, off)]
    if spread is None:
        log(f"{label}: checkpointing on vs off, losses equal bit for bit "
            f"at every step: {on == off} (gaps {gaps})")
        if on != off:
            raise AssertionError(f"{label}: checkpointed losses {on} != "
                                 f"{off}")
        return
    log(f"{label}: two runs without checkpointing differ by {spread}; "
        f"checkpointing on vs off {gaps}")
    if any(g > s for g, s in zip(gaps, spread)):
        raise AssertionError(f"{label}: checkpointed gaps {gaps} beyond "
                             f"the uncheckpointed spread {spread}")


def _recipe_ckpt_pair(dev, label, use_flash: bool, total: dict):
    """Legs a and b: the recipe with checkpointing on (traced, counted),
    then off from the same seed; the pair held bitwise (or, when two
    uncheckpointed runs differ on the card, to that spread)."""
    c_on, on, ms_on, mem_on = _recipe_leg(dev, f"{label} checkpointing on",
                                          use_flash=use_flash, trace=True)
    c_off, off, ms_off, mem_off = _recipe_leg(
        dev, f"{label} checkpointing off", use_flash=use_flash, ckpt=False)
    spread = None
    if on != off:
        setup, _ = recipe_setup(dev, checkpoint=False, use_flash=use_flash)
        again = recipe_run(setup, RECIPE_STEPS)[0]
        del setup
        free_memory()
        if again != off:
            spread = [abs(a - b) for a, b in zip(again, off)]
    _recipe_hold_pair(label, on, off, spread)
    log(f"{label}: checkpointing costs {ms_on / ms_off:.4f}x the step "
        f"({ms_on:.3f} against {ms_off:.3f} ms) and saves "
        f"{mem_off - mem_on:.3f} GiB of peak memory ({mem_on:.3f} against "
        f"{mem_off:.3f} GiB)")
    for c in (c_on, c_off):
        total.update(_add_counts(total, c))


def recipe_gaps(dev, route: str, seed: int, check_plain: bool = False):
    """|kernel - plain| losses of the recipe's first ``PLAIN_STEPS`` on
    ``route`` (staged, flash: staged with ``use_flash``, or pipeline)
    from ``seed``, checkpointing on; ``check_plain``: the plain run must
    launch nothing."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    kw = dict(use_flash=route == "flash", pipeline=route == "pipeline")
    pair = []
    for kernels in (True, False):
        reset_launch_counts()
        setup, _ = recipe_setup(dev, seed=seed, kernels=kernels, **kw)
        pair.append(recipe_run(setup, PLAIN_STEPS)[0])
        del setup
        free_memory()
        if check_plain and not kernels and any(launch_counts().values()):
            raise AssertionError(f"the plain {route} run launched kernels")
    return [abs(a - b) for a, b in zip(*pair)]


def recipe_medians(dev, label: str, routes=RECIPE_ROUTES):
    """Each route's step medians over ``TRAIN_SEEDS`` of |kernel - plain|
    (printed seed by seed)."""
    out = {}
    for route in routes:
        gaps = []
        for seed in TRAIN_SEEDS:
            gaps.append(recipe_gaps(dev, route, seed, check_plain=seed == 0))
            log(f"{label} {route} seed {seed}: |kernel - plain| "
                f"{[f'{x:.3e}' for x in gaps[-1]]}")
        out[route] = [float(np.median([g[i] for g in gaps]))
                      for i in range(PLAIN_STEPS)]
        log(f"{label} {route}: step medians over seeds {list(TRAIN_SEEDS)} "
            f"{[f'{x:.3e}' for x in out[route]]} (tol "
            f"{RECIPE_LOSS_TOL[route]})")
    return out


def _recipe_mp_lamb(dev, total: dict) -> None:
    """Leg d: ``FusedMixedPrecisionLamb`` stepping the bf16 model (the
    O5 policy's cast, no amp) with a dynamic scaler, ``RECIPE_STEPS``
    steps, an inf planted in a gradient at ``RECIPE_MP_INF_STEP``:
    masters, m, v, the parameters and the count bitwise as they were,
    the scale halved; the other steps finite; losses finite and
    falling; counts exact."""
    from apex_tpu_torch.amp import get_policy, scaler
    from apex_tpu_torch.amp.cast import cast_params
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FusedMixedPrecisionLamb
    from apex_tpu_torch.testing import standalone_bert as sb
    from apex_tpu_torch.transformer import DropoutRNG

    label = "train_bert_recipe d (FusedMixedPrecisionLamb)"
    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    args = recipe_args()
    net = sb.bert_model_provider(args, device=dev, num_tokentypes=0)
    cast_params(net, get_policy("O5"))
    params = list(net.parameters())
    sched = _TracedSchedule(recipe_lr(args))
    opt = FusedMixedPrecisionLamb(sched, weight_decay=args.weight_decay,
                                  max_grad_norm=args.clip_grad)
    state, sc = opt.init(params), scaler.init("dynamic")
    tokens, mask, labels, nsp = _recipe_batch(dev, args, 0)
    rng = DropoutRNG(1, dev)
    losses, rows = [], []
    with _ClipTrace() as clips:
        for step in range(1, RECIPE_STEPS + 1):
            for p in params:
                p.grad = None
            loss = sb.bert_loss(net, tokens, mask, labels, nsp, rng)
            (loss.float() * sc.loss_scale).backward()
            grads = [p.grad for p in params]
            planted = step == RECIPE_MP_INF_STEP
            if planted:
                grads[0].view(-1)[0] = math.inf
                before = [t.clone() for t in (*state.masters, *state.m,
                                              *state.v, *params)]
            count, scale = state.count, sc.loss_scale
            params, state, sc, info = opt.step(grads, state, params, sc)
            losses.append(float(loss.detach()))
            rows.append((step, info.grads_finite, scale, sc.loss_scale,
                         state.count))
            if planted:
                held = all(torch.equal(a, b) for a, b in zip(
                    before, (*state.masters, *state.m, *state.v, *params)))
                del before
                log(f"{label}: the planted inf at step {step}: finite "
                    f"{info.grads_finite}, masters/m/v/params held bitwise "
                    f"{held}, count {count} -> {state.count}, scale "
                    f"{scale:g} -> {sc.loss_scale:g}")
                if info.grads_finite or not held or state.count != count \
                        or sc.loss_scale != scale / 2:
                    raise AssertionError(f"{label}: the overflow step was "
                                         f"not held")
            elif not info.grads_finite or state.count != count + 1:
                raise AssertionError(f"{label}: step {step} not applied")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = _recipe_want(counts, args.num_layers, RECIPE_STEPS, ckpt=True,
                        use_flash=False, phase1=0)
    want["lamb_phase1"] = len(params) * (RECIPE_STEPS - 1)
    norms = [(round(n, 4), round(c, 6)) for n, c, _ in clips.read()]
    log(f"{label}: losses {[round(x, 6) for x in losses]}; (step, finite, "
        f"scale before, after, count) {rows}; (scaled norm, clip) {norms}; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2 ** 30:.3f} "
        f"GiB; launch counts { {k: v for k, v in counts.items() if v} }")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    applied = [x for x, r in zip(losses, rows) if r[1]]
    if not all(math.isfinite(x) for x in applied) or \
            not applied[-1] < applied[0]:
        raise AssertionError(f"{label}: losses not finite and falling")
    total.update(_add_counts(total, counts))
    del net, params, state, opt
    free_memory()


_RECIPE_FAULT_LEG = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from apex_tpu_torch import _build
_build.build()
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
mode, arg = sys.argv[1], sys.argv[2]
if mode == "pair":
    out = cs.recipe_pair_losses(dev, int(arg))
else:
    out = cs.recipe_medians(dev, "recipe_faults", tuple(arg.split(",")))
print("FAULT " + json.dumps(out), flush=True)
"""


def _in_faulty_copy(tmp, name, source, edits, argv):
    """Run ``_RECIPE_FAULT_LEG`` with ``argv`` in a copy of the port with
    ``edits`` (sound, faulty, ...) applied to ``source``; its result."""
    root = Path(__file__).resolve().parent
    d = Path(tmp) / name
    shutil.copytree(root / "apex_tpu_torch", d / "apex_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "chip_smoke.py", d)
    src = d / "apex_tpu_torch" / source
    text = src.read_text()
    for sound, faulty in zip(edits[::2], edits[1::2]):
        if sound not in text:
            raise AssertionError(f"fault {name}: {sound!r} not found")
        text = text.replace(sound, faulty)
    src.write_text(text)
    out = subprocess.run([sys.executable, "-c", _RECIPE_FAULT_LEG, *argv],
                         cwd=d, capture_output=True, text=True, timeout=1500)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("FAULT ")]
    for ln in out.stdout.splitlines():
        if ln.startswith("recipe_faults"):
            log(f"  [{name}] {ln}")
    if out.returncode != 0 or not lines:
        raise AssertionError(f"fault {name}: the leg failed "
                             f"({out.returncode}):\n{out.stderr[-3000:]}")
    return json.loads(lines[-1][len("FAULT "):])


def _recipe_no_replay(dev) -> None:
    """Leg f: the checkpoint wrapper without its generator replay
    (``RECIPE_CKPT_FAULT``, planted in a copy of the port): leg a's pair
    over ``PLAIN_STEPS`` steps must no longer be bitwise."""
    source, *edits = RECIPE_CKPT_FAULT
    with tempfile.TemporaryDirectory() as tmp:
        on, off = _in_faulty_copy(tmp, "ckpt_no_replay", source, edits,
                                  ["pair", str(PLAIN_STEPS)])
    gaps = [abs(a - b) for a, b in zip(on, off)]
    log(f"train_bert_recipe f: the checkpoint wrapper without its replay "
        f"({' / '.join(edits[1::2])}): losses on {on}, off {off}, gaps "
        f"{[f'{x:.3e}' for x in gaps]}: the bitwise hold "
        f"{'breaks' if on != off else 'HOLDS (FAIL)'}")
    if on == off:
        raise AssertionError("the planted wrapper fault kept the pair "
                             "bitwise")


def train_bert_recipe(dev) -> dict:
    """Phase 6g: Megatron's BERT-large recipe (legs a-f).  Returns the
    launch counts of the counted runs (legs a, b, c's pipeline run, d)."""
    total = {}
    _recipe_ckpt_pair(dev, "train_bert_recipe a (staged)", False, total)
    _recipe_ckpt_pair(dev, "train_bert_recipe b (flash)", True, total)
    counts, *_ = _recipe_leg(dev, "train_bert_recipe c (pipeline)",
                             use_flash=False, pipeline=True, trace=True)
    total.update(_add_counts(total, counts))
    _recipe_mp_lamb(dev, total)
    meds = recipe_medians(dev, "train_bert_recipe c")
    for route, med in meds.items():
        if any(m > t for m, t in zip(med, RECIPE_LOSS_TOL[route])):
            raise AssertionError(f"train_bert_recipe c {route}: medians "
                                 f"{med} beyond {RECIPE_LOSS_TOL[route]}")
    _recipe_no_replay(dev)
    log(f"train_bert_recipe: launch counts of the counted runs "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


def recipe_faults(dev) -> None:
    """Only when named: each of ``RECIPE_LOSS_FAULTS`` planted in a copy
    of the port, and leg c's step medians on the routes it reaches: the
    readings ``RECIPE_LOSS_TOL`` sits below."""
    with tempfile.TemporaryDirectory() as tmp:
        for name, (source, routes, *edits) in RECIPE_LOSS_FAULTS.items():
            meds = _in_faulty_copy(tmp, name, source, edits,
                                   ["medians", ",".join(routes)])
            for route, med in meds.items():
                caught = any(m > t for m, t in zip(med,
                                                   RECIPE_LOSS_TOL[route]))
                log(f"recipe_faults {name} ({' / '.join(edits[1::2])}) "
                    f"{route}: step medians {[f'{x:.3e}' for x in med]} "
                    f"(tol {RECIPE_LOSS_TOL[route]}): caught {caught}")


# --- the flash forward's numerics (run only when named) -------------------

# (b, h, s, d, std) of the causal bf16 inputs the numerics probe reads:
# unit-normal, and std 0.64, the O5 train step's q and k at initialization
# (near-uniform rows whose o is a mean of many v rows)
NUMERICS_CASES = ((8, 16, 1024, 64, 1.0), (8, 16, 1024, 64, 0.64),
                  (1, 16, 2048, 128, 1.0))
# the forwards the loss-gap spread runs besides the kernel's: its o with
# the plain version's lse, and the plain version's o with its lse
SPREAD_HYBRIDS = ("kernel o, plain lse", "plain o, kernel lse")


def flash_numerics(dev) -> None:
    """How the flash forward (``flash_attention_with_lse``) and its plain
    version (``mha_reference``) round against a float64 evaluation, on
    ``NUMERICS_CASES``: o's signed error relative to |o| (a bias of the
    fp32 sums shows here; the bf16 rounding averages out), its mean
    absolute error, lse's mean signed error, the elements where the two
    bf16 o differ, and the kernel's device ms."""
    from apex_tpu_torch.ops import flash_attention_with_lse, mha_reference

    for b, h, s, d, std in NUMERICS_CASES:
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = ((std * torch.randn(b, h, s, d, generator=gen, device=dev))
                   .bfloat16() for _ in range(3))
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
        o_p, lse_p = mha_reference(q, k, v, causal=True, return_lse=True)
        sc = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) \
            * d ** -0.5
        keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        sc = sc.masked_fill(~keep, -math.inf)
        lse_x = torch.logsumexp(sc, -1)
        ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1),
                           v.double())
        del sc
        row = {}
        for name, x, lx in (("kernel", o, lse), ("plain", o_p, lse_p)):
            err = x.double() - ref
            row[name] = (float((err * ref.sign()).sum() / ref.abs().sum()),
                         float(err.abs().sum() / ref.abs().sum()),
                         float((lx.double() - lse_x).mean()))
        ms = time_ms(lambda: flash_attention_with_lse(q, k, v, causal=True))[0]
        log(f"numerics ({b}, {h}, {s}, {d}) std {std}: o signed error "
            f"kernel {row['kernel'][0]:.4e} plain {row['plain'][0]:.4e}, "
            f"mean |error| kernel {row['kernel'][1]:.6e} plain "
            f"{row['plain'][1]:.6e} (of |o|); lse signed error kernel "
            f"{row['kernel'][2]:.4e} plain {row['plain'][2]:.4e}; bf16 o "
            f"differs on {int((o != o_p).sum())} of {o.numel()}; kernel "
            f"{ms:.5f} ms")
        del q, k, v, o, o_p, lse, lse_p, lse_x, ref
        free_memory()


def _spread_losses(dev, family: str, seed: int, forward: str):
    """The first ``PLAIN_STEPS`` O5 losses of ``family`` from ``seed``,
    with ``forward`` the E forward: "kernel", "plain" (every kernel's
    plain version), or a ``SPREAD_HYBRIDS`` mix of the kernel's o and
    lse with the plain version's (the kernel backward reads them)."""
    # the module (the package exports its function of the same name)
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    mod, model = _train_module(family)
    kw = TRAIN_KW.get(family, {})
    if forward in ("kernel", "plain"):
        return mod.train_smoke(
            PLAIN_STEPS, model=model, seed=seed, kernels=forward == "kernel",
            device=dev, **kw).losses
    kernel = fa._forward_e

    def mixed(qkv, scale, causal, kv_mask=None, drop=None):
        o, lse = kernel(qkv, scale, causal, kv_mask, drop)
        q, k, v = fa._split_e(qkv)
        b, s, h, _ = qkv.shape
        o_p, lse_p = fa.mha_reference(
            q, k, v, scale=scale, causal=causal, return_lse=True,
            kv_mask=kv_mask, **fa._ref_drop(drop, b, h, s, s, qkv.device))
        if forward == SPREAD_HYBRIDS[0]:
            return o, lse_p
        return o_p.transpose(1, 2).contiguous(), lse

    fa._forward_e = mixed
    try:
        return mod.train_smoke(PLAIN_STEPS, model=model, seed=seed,
                               device=dev, **kw).losses
    finally:
        fa._forward_e = kernel


def train_spread(dev) -> None:
    """The O5 train steps' |kernel - plain| loss gaps against their
    limits over ``TRAIN_SEEDS``: for each of ``SEEDED_FAMILIES``, seed
    and forward (the kernel's, and ``SPREAD_HYBRIDS``), the gaps of the
    first ``PLAIN_STEPS`` steps and the largest gap over its limit: how
    the single-seed gaps spread, and which of the forward's outputs moves
    them; then each forward's step medians over the seeds, the numbers
    the train checks hold.  Run in a copy with a planted fault, the
    medians say whether the limits still catch it."""
    tols = {"gpt": (TRAIN_LOSS_TOL,) * PLAIN_STEPS,
            "gpt_long": TRAIN_LONG_LOSS_TOL,
            "gpt_dropout": TRAIN_DROPOUT_LOSS_TOL,
            "bert": TRAIN_BERT_LOSS_TOL}
    for family in SEEDED_FAMILIES:
        worst, by_seed = {}, {}
        for seed in TRAIN_SEEDS:
            plain = _spread_losses(dev, family, seed, "plain")
            free_memory()
            for forward in ("kernel",) + tuple(SPREAD_HYBRIDS):
                losses = _spread_losses(dev, family, seed, forward)
                free_memory()
                gaps = [abs(a - b) for a, b in zip(losses, plain)]
                ratio = max(g / t for g, t in zip(gaps, tols[family]))
                worst.setdefault(forward, []).append(ratio)
                by_seed.setdefault(forward, []).append(gaps)
                log(f"spread {family} seed {seed} {forward}: |kernel - "
                    f"plain| {[f'{g:.2e}' for g in gaps]} (tol "
                    f"{tols[family]}): {ratio:.3f} of the limit")
        for forward, ratios in worst.items():
            med = [float(np.median([g[i] for g in by_seed[forward]]))
                   for i in range(PLAIN_STEPS)]
            log(f"spread {family} {forward}: step medians "
                f"{[f'{m:.3e}' for m in med]} (tol {tols[family]}), "
                f"{max(m / t for m, t in zip(med, tols[family])):.3f} of the "
                f"limit; largest gap over its limit by seed "
                f"{[round(r, 3) for r in ratios]}; "
                f"{sum(r <= 1 for r in ratios)} of {len(ratios)} seeds "
                f"within every limit")


# --- the update slice's phases -------------------------------------------

def _seeded_leaves(dev, seed: int, shapes):
    """bench.py's synthetic parameters (0.01 randn, fp32) from a seeded
    generator on the card, and the gradients g = p * 1e-3 + 1e-3."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = [0.01 * torch.randn(s, generator=gen, device=dev) for s in shapes]
    return p, [x * 1e-3 + 1e-3 for x in p]


def _update_step(tx, p, g, holder):
    """One ``update`` + ``apply_updates`` step on g_t = g + 1e-12 p (the
    bench's step-dependent gradients), the state kept in ``holder``."""
    from apex_tpu_torch.optimizers import apply_updates

    g_t = [gg + 1e-12 * pp for gg, pp in zip(g, p)]
    u, holder[0] = tx.update(g_t, holder[0], p)
    apply_updates(p, u)


def _state_tensors(state):
    """The tensors of an optimizer state dataclass, count left out, field
    by field."""
    return [t for f in dataclasses.fields(state) if f.name != "count"
            for t in getattr(state, f.name)]


def _zero_side(dev, tx, label: str, want: dict):
    """One side of bench_zero_adam's pair: ``ZERO_STEPS`` counted steps
    from fresh parameters and state (launch counts reset just before and
    held to ``want``; peak memory; wall ms a step), then the device and
    back-to-back times a step on further steps.  Returns (the parameters
    and the state tensors after the counted steps, the launch counts read
    after them, device ms, wall ms, peak GiB above what the caller
    holds)."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    held = torch.cuda.memory_allocated(dev)     # what the caller keeps
    p, g = _seeded_leaves(dev, 12, ZERO_SHAPES)
    holder = [tx.init(p)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(ZERO_STEPS):
        _update_step(tx, p, g, holder)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / ZERO_STEPS
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2 ** 30
    expect = {k: 0 for k in counts}
    expect.update(want)
    log(f"zero_adam {label}: launch counts "
        f"{ {k: v for k, v in counts.items() if v} } (expected {want}); "
        f"wall {wall:.3f} ms a step over the {ZERO_STEPS} counted steps; "
        f"peak memory {peak:.2f} GiB")
    if counts != expect:
        raise AssertionError(f"zero_adam {label}: launch counts {counts} "
                             f"!= {expect}")
    final = [x.clone() for x in p]
    # update() returns new state tensors: the timed steps leave these be
    state = _state_tensors(holder[0])
    if not all(bool(torch.isfinite(x).all()) for x in final + state):
        raise AssertionError(f"zero_adam {label}: parameters or state not "
                             f"finite")
    dev_ms, wall_b2b = time_ms(lambda: _update_step(tx, p, g, holder),
                               iters=ZERO_STEPS, warmup=1)
    log(f"zero_adam {label}: device {dev_ms:.3f} ms a step (back to back "
        f"{wall_b2b:.3f} ms)")
    del p, g, holder
    free_memory()
    return final, state, counts, dev_ms, wall, peak


def zero_adam(dev) -> dict:
    """bench.py's bench_zero_adam pair at 355,000,320 parameters, each
    side held to the plain version at its own shapes: first
    ``fused_adam(1e-3, kernels=False)`` (no launch), then the dense
    ``fused_adam(1e-3).update`` + ``apply_updates`` (10 ``adam_update``
    launches a step, one a leaf), then ``distributed_fused_adam(1e-3)``
    over a one-rank NCCL group (one launch a step, on the one packed fp32
    group), ``ZERO_STEPS`` steps each from the same seeded parameters:
    exact launch counts; each kernel side's parameters and moments after
    the steps bitwise equal to the plain side's (the sharded moments
    against the plain ones packed; world 1 divides by 1, and every
    element meets the same arithmetic); device and wall ms a step, the
    sides' ratio (``sharded_vs_dense_device``, bench.py's name), peak
    memory and the bound.  Returns the launch counts the two kernel
    sides read."""
    import torch.distributed as dist

    from apex_tpu_torch.contrib.optimizers import distributed_fused_adam
    from apex_tpu_torch.ops import multi_tensor
    from apex_tpu_torch.optimizers import fused_adam

    n = sum(a * b for a, b in ZERO_SHAPES)
    plain_p, plain_st, _, plain_ms, plain_wall, _ = _zero_side(
        dev, fused_adam(ZERO_LR, kernels=False), "plain fused_adam "
        "(kernels=False)", {})
    dense_p, dense_st, dense_counts, dense_ms, dense_wall, dense_peak = \
        _zero_side(dev, fused_adam(ZERO_LR), "dense fused_adam",
                   {"adam_update": len(ZERO_SHAPES) * ZERO_STEPS})
    _bitwise("zero_adam dense against plain (parameters, m, v)",
             dense_p + dense_st, plain_p + plain_st)
    del dense_p, dense_st
    free_memory()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        # NCCL builds its communicator at the first collective: outside
        # the counted steps' wall
        dist.all_reduce(torch.zeros(1, device=dev))
        zero_p, zero_st, zero_counts, zero_ms, zero_wall, zero_peak = \
            _zero_side(dev, distributed_fused_adam(ZERO_LR), "sharded "
                       "distributed_fused_adam (one-rank NCCL group)",
                       {"adam_update": ZERO_STEPS})
    finally:
        dist.destroy_process_group()
    half = len(plain_st) // 2           # the plain m leaves, then the v
    packed = [b for leaves in (plain_st[:half], plain_st[half:])
              for b in multi_tensor.pack(
                  leaves, multi_tensor.compute_metas(leaves))]
    _bitwise("zero_adam sharded against plain (parameters, packed m, v)",
             zero_p + zero_st, plain_p + packed)
    b_ms, b_by = bound_ms(28 * n, UPDATE_FLOPS["adam_update"] * n,
                          FP32_FLOPS)
    log(f"zero_adam: {n} fp32 parameters in {len(ZERO_SHAPES)} leaves, "
        f"{ZERO_STEPS} steps a side; dense device {dense_ms:.3f} ms a step "
        f"(wall {dense_wall:.3f}), sharded {zero_ms:.3f} (wall "
        f"{zero_wall:.3f}), plain {plain_ms:.3f} (wall {plain_wall:.3f}): "
        f"sharded_vs_dense_device {zero_ms / dense_ms:.4f}, "
        f"sharded_vs_dense_wall {zero_wall / dense_wall:.4f}; peak memory "
        f"dense {dense_peak:.2f} GiB, sharded {zero_peak:.2f} GiB; the "
        f"Adam update's bound {b_ms:.3f} ms a step ({b_by}, 28 bytes an "
        f"element); parameters and moments of both sides after "
        f"{ZERO_STEPS} steps bitwise equal to the plain version's ok")
    del zero_p, zero_st, plain_p, plain_st, packed
    free_memory()
    return {k: dense_counts[k] + zero_counts[k] for k in dense_counts}


def optim_update(dev) -> dict:
    """``update`` of fused_adam, fused_sgd (momentum 0.9), fused_adagrad
    and fused_novograd on bench.py's small_leaves_26m_packed tree with
    every leaf packed (``multi_tensor.DIRECT_MIN_ELEMS`` raised above the
    leaf size, restored after): ``OPTIM_STEPS`` steps each with launch
    counts reset just before and held exactly (``OPTIM_GROUPS`` launches a
    step, the grouping's count, checked before the run), then the same
    steps with ``kernels=False``: parameters and state bitwise equal.
    Returns the path's launch counts."""
    from apex_tpu_torch.ops import (launch_counts, multi_tensor,
                                    reset_launch_counts)
    from apex_tpu_torch.optimizers import (fused_adagrad, fused_adam,
                                           fused_novograd, fused_sgd)

    opts = (("adam_update", lambda k: fused_adam(1e-3, kernels=k)),
            ("sgd_update", lambda k: fused_sgd(0.1, momentum=0.9,
                                               kernels=k)),
            ("adagrad_update", lambda k: fused_adagrad(1e-2, kernels=k)),
            ("novograd_update", lambda k: fused_novograd(1e-3, kernels=k)))
    saved = multi_tensor.DIRECT_MIN_ELEMS
    multi_tensor.DIRECT_MIN_ELEMS = max(a * b for a, b in OPTIM_SHAPES) + 1
    total = {}
    try:
        p, _ = _seeded_leaves(dev, 13, OPTIM_SHAPES)
        for align in (1, multi_tensor.LANE):
            metas = multi_tensor.compute_metas(p, align=align,
                                               split_direct=True)
            if len(metas) != OPTIM_GROUPS or any(m.direct for m in metas):
                raise AssertionError(f"optim_update: {len(metas)} groups "
                                     f"at align {align}, not "
                                     f"{OPTIM_GROUPS} packed")
        log(f"optim_update: {len(OPTIM_SHAPES)} leaves, "
            f"{sum(a * b for a, b in OPTIM_SHAPES)} fp32 elements, "
            f"DIRECT_MIN_ELEMS {multi_tensor.DIRECT_MIN_ELEMS}: "
            f"{OPTIM_GROUPS} packed groups of "
            f"{[len(m.sizes) for m in metas]} leaves, so {OPTIM_GROUPS} "
            f"launches a step an optimizer")
        del p
        for name, make in opts:
            runs = []
            for kernels in (True, False):
                p, g = _seeded_leaves(dev, 13, OPTIM_SHAPES)
                tx = make(kernels)
                holder = [tx.init(p)]
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                for _ in range(OPTIM_STEPS):
                    _update_step(tx, p, g, holder)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / OPTIM_STEPS
                counts = launch_counts()
                want = {k: 0 for k in counts}
                if kernels:
                    want[name] = OPTIM_GROUPS * OPTIM_STEPS
                if counts != want:
                    raise AssertionError(f"optim_update {name} kernels="
                                         f"{kernels}: launch counts {counts}")
                if kernels:
                    total[name] = counts[name]
                runs.append((p, _state_tensors(holder[0]), wall))
            _bitwise(f"optim_update {name}", runs[0][0] + runs[0][1],
                     runs[1][0] + runs[1][1])
            log(f"optim_update {name}: {OPTIM_STEPS} steps, "
                f"{total[name]} launches (held); parameters "
                f"and state bitwise equal to kernels=False ok; wall "
                f"{runs[0][2]:.3f} ms a step (plain {runs[1][2]:.3f})")
            del runs
            free_memory()
    finally:
        multi_tensor.DIRECT_MIN_ELEMS = saved
    return total


# --- the ring slice: flash_attention_partial, flash_attention_qkv and --
# --- contrib/multihead_attn --------------------------------------------

def _flash_bound(b, h, sq, sk, d, pairs, bwd, extra_bytes=0.0):
    """The card's bound on a (b, h, s, d) flash call: bf16 operands read
    once and outputs written once (forward q, k, v, o; backward also do,
    dq, dk, dv), the fp32 lse, ``extra_bytes`` (a mask, the lse
    cotangent), 4 d (forward) or 10 d (backward) operations an attended
    pair (``pairs`` in all)."""
    rows = b * h * d * 2
    nbytes = (2 * rows * (sq + sk) if bwd else rows * (2 * sq + 2 * sk)) \
        + b * h * sq * 4 + extra_bytes
    return bound_ms(nbytes, (10.0 if bwd else 4.0) * d * pairs, BF16_FLOPS)


def _ring_merge(o, lse, bo, blse):
    """bench_ring_flash's merge of a partial (bo, blse) onto the carry
    (o, lse): logaddexp of the lse, the outputs reweighted, in fp32."""
    lse_new = torch.logaddexp(lse, blse)
    return (o * torch.exp(lse - lse_new)[..., None]
            + bo.float() * torch.exp(blse - lse_new)[..., None]), lse_new


def _ring_loss(o0, lse0, bo, blse):
    """The substep's loss, bench.py's: sum(o2**2) + 0 * sum(lse2)."""
    o2, lse2 = _ring_merge(o0, lse0, bo, blse)
    return (o2 ** 2).sum() + 0.0 * lse2.sum()


def _ring_grads(q, k, v, o0, lse0, kw):
    """One substep under autograd: the partial, the merge, the loss's
    backward; returns (dq, dk, dv)."""
    from apex_tpu_torch.ops import flash_attention_partial

    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _ring_loss(o0, lse0, *flash_attention_partial(*ts, **kw)).backward()
    return [t.grad for t in ts]


def _partial_holds(label, q, k, v, grads, kw, cotangents):
    """The partial's (o, lse) against its plain version on the same
    inputs, and the gradients ``grads`` the kernels gave under the
    cotangents ``cotangents(o, lse)`` returns against the plain backward
    given those cotangents; returns (o, lse, do, dlse, forward err,
    backward err)."""
    from apex_tpu_torch.ops import (flash_attention_backward_reference,
                                    flash_attention_partial,
                                    flash_attention_partial_reference,
                                    rand_keep_global)

    o, lse = flash_attention_partial(q, k, v, **kw)
    torch.cuda.synchronize()
    o_r, lse_r = flash_attention_partial_reference(q, k, v, **kw)
    err, lerr = _hold_forward(f"kernel {label}", o, o_r, lse, lse_r)
    del o_r, lse_r
    do, dlse = cotangents(o, lse)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    drop = {}
    if kw.get("dropout_rate"):
        drop = dict(dropout_rate=kw["dropout_rate"], dropout_keep=
                    rand_keep_global((b, h, sq, sk), kw["dropout_seed"],
                                     kw["dropout_rate"],
                                     head_offset=kw["head_offset"],
                                     q_offset=kw["q_offset"],
                                     k_offset=kw["k_offset"], device=q.device))
    want = flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=kw["causal"],
        q_offset=kw["q_offset"], k_offset=kw["k_offset"], dlse=dlse, **drop)
    berr = _hold_backward(f"{label}_bwd", grads, want)
    del want, drop
    free_memory()
    return o, lse, do, dlse, max(err, lerr), berr


def _merge_cotangents(o0, lse0):
    """The cotangents the substep's merge hands the partial."""
    def cotangents(o, lse):
        bo, blse = (t.detach().requires_grad_(True) for t in (o, lse))
        do, dlse = torch.autograd.grad(_ring_loss(o0, lse0, bo, blse),
                                       (bo, blse))
        return do.to(o.dtype), dlse
    return cotangents


def _sin_cotangents(o, lse):
    """The cotangents of JAX's partial test loss sum(o**2) +
    sum(sin(lse)): the lse cotangent cos(lse) is far from 0."""
    return (2 * o.float()).to(o.dtype), torch.cos(lse)


def _sin_grads(q, k, v, kw):
    from apex_tpu_torch.ops import flash_attention_partial

    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention_partial(*ts, **kw)
    ((o.float() ** 2).sum() + torch.sin(lse).sum()).backward()
    return [t.grad for t in ts]


def _readback_keep_partial(dev, b, h, s, d, kw):
    """The keep mask each partial dropout kernel drew at (b, h, s, d),
    read back bit for bit as :func:`_readback_keep` does for the E
    kernels, on full attention (the coordinate hash does not depend on
    the causal mask): q = 0, so each row's p is 1/s over all s keys;
    per window of d keys k and v one-hot on it for the forward and dQ
    passes (do all ones), per window of d rows q = k = v = 0 and do
    one-hot on it for the dK/dV pass.  Returns the three (b, h, s, s)
    bool masks."""
    from apex_tpu_torch.ops import flash_attention_partial

    fwd, dq, dkv = (torch.empty((b, h, s, s), dtype=torch.bool, device=dev)
                    for _ in range(3))
    eye = torch.eye(d, device=dev, dtype=torch.bfloat16)
    zeros = torch.zeros(b, h, s, d, device=dev, dtype=torch.bfloat16)
    ones = torch.ones_like(zeros)
    kw = dict(kw, causal=False)

    def run(k, v, do):
        ts = [t.clone().requires_grad_(True) for t in (zeros, k, v)]
        o, _ = flash_attention_partial(*ts, **kw)
        return (o.detach(),) + torch.autograd.grad(o, ts, do)

    for c0 in range(0, s, d):
        kv = zeros.clone()
        kv[:, :, c0:c0 + d] = eye
        o, g_q, _, _ = run(kv, kv, ones)
        fwd[..., c0:c0 + d] = o != 0
        dq[..., c0:c0 + d] = g_q > 0
    for r0 in range(0, s, d):
        do = zeros.clone()
        do[:, :, r0:r0 + d] = eye
        _, _, _, g_v = run(zeros, zeros, do)
        dkv[:, :, r0:r0 + d] = (g_v != 0).transpose(-1, -2)
    torch.cuda.synchronize()
    return fwd, dq, dkv


def _ring_time(label, q, k, v, kw, o0, lse0):
    """The partial's forward, its backward under the merge's cotangents
    (the autograd call a substep makes), the plain versions and SDPA's,
    at the ring shape; returns the forward and backward entries."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention_backward_reference,
                                    flash_attention_partial,
                                    flash_attention_partial_reference,
                                    rand_keep_global)

    b, h, s, d = q.shape
    rate = kw.get("dropout_rate", 0.0)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bo, blse = flash_attention_partial(*ts, **kw)
    do, dlse = _merge_cotangents(o0, lse0)(bo, blse)
    fms, fms_w = time_ms(lambda: flash_attention_partial(q, k, v, **kw),
                         iters=5, warmup=1)
    bms, bms_w = time_ms(lambda: torch.autograd.grad(
        (bo, blse), ts, (do, dlse), retain_graph=True), iters=5, warmup=1)
    sub, sub_w = time_ms(lambda: _ring_grads(q, k, v, o0, lse0, kw),
                         iters=5, warmup=1)
    pf, _ = time_ms(lambda: flash_attention_partial_reference(q, k, v, **kw),
                    iters=3, warmup=1)
    drop = {}
    if rate:
        drop = dict(dropout_rate=rate, dropout_keep=rand_keep_global(
            (b, h, s, s), kw["dropout_seed"], rate,
            head_offset=kw["head_offset"], q_offset=kw["q_offset"],
            k_offset=kw["k_offset"], device=q.device))
    pb, _ = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, bo.detach(), blse.detach(), do, causal=True,
        q_offset=kw["q_offset"], k_offset=kw["k_offset"], dlse=dlse, **drop),
        iters=3, warmup=1)
    del drop
    free_memory()
    # every pair is visible at these offsets: SDPA without a mask
    lf, _ = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=rate), iters=5, warmup=1)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out_s = F.scaled_dot_product_attention(qs, ks, vs, dropout_p=rate)
    lb, _ = time_ms(lambda: torch.autograd.grad(
        out_s, (qs, ks, vs), do, retain_graph=True), iters=5, warmup=1)
    del out_s, qs, ks, vs
    pairs = float(b * h * s * s)    # every pair visible at the ring's offsets
    fb, fby = _flash_bound(b, h, s, s, d, pairs, False)
    bb, bby = _flash_bound(b, h, s, s, d, pairs, True, b * h * s * 4)
    flops = 14.0 * b * h * s * s * d
    tf = flops / ((fms + bms) / 1e3) / 1e12
    shape = (f"b={b} h={h} s_local={s} d={d} causal q_offset={kw['q_offset']} "
             f"k_offset={kw['k_offset']} bf16"
             + (f", dropout {rate} head_offset {kw['head_offset']}"
                if rate else ""))
    log(f"  {label} time {shape}, device ms (wall ms per call): forward "
        f"kernel {fms:.5f} ({fms_w:.5f}), plain {pf:.5f}, SDPA "
        f"{'dropout_p ' + str(rate) + ' ' if rate else ''}{lf:.5f}, bound "
        f"{fb:.5f} ({fby}); backward kernel {bms:.5f} ({bms_w:.5f}), plain "
        f"{pb:.5f}, SDPA backward {lb:.5f}, bound {bb:.5f} ({bby}); the "
        f"partial's forward and backward {fms + bms:.5f} ms, "
        f"{tf:.3f} model TFLOP/s at 14 b h s^2 d ({flops:.4g} FLOP; "
        f"{100 * tf / (BF16_FLOPS / 1e12):.2f}% of 989); the whole substep "
        f"(partial, merge, loss, backward under autograd) {sub:.5f} "
        f"({sub_w:.5f}), {flops / (sub / 1e3) / 1e12:.3f} TFLOP/s, bound at "
        f"989 TFLOP/s {flops / BF16_FLOPS * 1e3:.5f}")
    del bo, blse, ts, do, dlse
    free_memory()
    name = "flash_attention_partial" + ("_dropout" if rate else "")
    bname = "flash_attention_partial_bwd" + ("_dropout" if rate else "")
    fwd = dict(name=name, shape=shape, ms=fms, ms_wall=fms_w, plain_ms=pf,
               bound_ms=fb, bound_by=fby, library_ms=lf)
    bwd = dict(name=bname, shape=shape, ms=bms, ms_wall=bms_w, plain_ms=pb,
               bound_ms=bb, bound_by=bby, library_ms=lb)
    return fwd, bwd


def ring_flash(dev):
    """bench.py's bench_ring_flash substep on the port: q, k, v drawn
    bf16 (randn * 0.5) at (b, h, s_local, d) = ``RING_SHAPE``, one
    ``flash_attention_partial`` call at q_offset = s_local, k_offset = 0
    (every key visible), the logaddexp merge onto o = 0, lse = -1e30
    (fp32), loss sum(o2**2) + 0 * sum(lse2) (the lse reached through the
    merge), dq, dk, dv by autograd; then the same substep at attention
    dropout ``RING_DROPOUT`` with head_offset ``RING_HEAD_OFFSET`` (a
    rank's shard of a head-split ring).  Launch counts reset just before
    the two substeps and held exactly.  Outside the count: each
    substep's o, lse and gradients against the plain versions on the same
    inputs (the merge's cotangents), timed with SDPA as the library
    column and the substep's TFLOP/s at 14 b h s^2 d; at s =
    ``RING_CASES_S``: the diagonal block (the mask cuts), a wholly future
    block (o = 0, JAX's lse -1e30 * scale bitwise, zero gradients, the
    merge returning the live partial unchanged) and the diagonal block at
    dropout with a head offset, under the loss sum(o**2) + sum(sin(lse))
    (a large lse cotangent); the dropout kernels' keep masks read back
    bit-equal to ``rand_keep_global``.  Returns (counts, entries)."""
    from apex_tpu_torch.ops import (flash_attention_partial, launch_counts,
                                    rand_keep_global, reset_launch_counts)
    from apex_tpu_torch.ops.flash_attention import (_coord_hash24,
                                                    _dead_lse, _partial_drop)

    b, h, s, d = RING_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    q, k, v = ((0.5 * torch.randn(b, h, s, d, generator=g, device=dev))
               .bfloat16() for _ in range(3))
    o0 = torch.zeros(b, h, s, d, device=dev)
    lse0 = torch.full((b, h, s), -1e30, device=dev)
    plain_kw = dict(causal=True, q_offset=s, k_offset=0)
    drop_kw = dict(plain_kw, dropout_rate=RING_DROPOUT,
                   dropout_seed=RING_SEED, head_offset=RING_HEAD_OFFSET)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    grads = [_ring_grads(q, k, v, o0, lse0, kw) for kw in (plain_kw,
                                                           drop_kw)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want.update({name: 1 for name in RING_FLASH_KERNELS})
    log(f"ring_flash: 2 substeps (b={b} h={h} s_local={s} d={d} bf16, the "
        f"partial at q_offset {s} k_offset 0, merge, loss, backward; the "
        f"second at dropout {RING_DROPOUT} head_offset {RING_HEAD_OFFSET}) "
        f"in {wall:.2f} s; launch counts "
        f"{ {n: c for n, c in counts.items() if c} } (expected "
        f"{ {n: c for n, c in want.items() if c} })")
    if counts != want:
        raise AssertionError(f"ring_flash launch counts {counts} != {want}")
    entries = {}
    for label, kw, gr in (("flash_attention_partial", plain_kw, grads[0]),
                          ("flash_attention_partial_dropout", drop_kw,
                           grads[1])):
        *_, ferr, berr = _partial_holds(
            f"ring_flash {label} b={b} h={h} s_local={s} d={d}", q, k, v, gr,
            kw, _merge_cotangents(o0, lse0))
        fwd, bwd = _ring_time(label, q, k, v, kw, o0, lse0)
        fwd["max_abs_err"], bwd["max_abs_err"] = ferr, berr
        entries[fwd["name"]], entries[bwd["name"]] = fwd, bwd
    del grads
    free_memory()

    # the smaller cases, under the loss with a large lse cotangent
    sc = RING_CASES_S
    q, k, v = ((0.5 * torch.randn(b, h, sc, d, generator=g, device=dev))
               .bfloat16() for _ in range(3))
    diag_kw = dict(causal=True, q_offset=sc, k_offset=sc)
    o_live, lse_live, *_, ferr, berr = _partial_holds(
        f"ring_flash diagonal block (the mask cuts) b={b} h={h} s={sc}",
        q, k, v, _sin_grads(q, k, v, diag_kw), diag_kw, _sin_cotangents)
    entries["flash_attention_partial"]["diagonal"] = dict(
        shape=f"b={b} h={h} s={sc} d={d} q_offset=k_offset={sc}",
        max_abs_err=max(ferr, berr))
    fut_kw = dict(causal=True, q_offset=0, k_offset=sc)
    o_f, lse_f = flash_attention_partial(q, k, v, **fut_kw)
    gf = _sin_grads(q, k, v, fut_kw)
    dead = _dead_lse(d ** -0.5)
    o_m, lse_m = _ring_merge(o_live.float(), lse_live, o_f, lse_f)
    ok = bool((o_f == 0).all()) and bool((lse_f == dead).all()) and \
        all(bool((t == 0).all()) for t in gf) and \
        torch.equal(o_m, o_live.float()) and torch.equal(lse_m, lse_live)
    log(f"kernel ring_flash wholly future block (q_offset 0, k_offset {sc}): "
        f"o exactly 0, lse exactly JAX's {dead!r} (-1e30 * scale in fp32), "
        f"gradients exactly 0 under a nonzero lse cotangent, and its merge "
        f"onto the live diagonal partial returns that partial bitwise: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a wholly future partial is not dead as JAX's")
    ddrop_kw = dict(diag_kw, dropout_rate=RING_DROPOUT, dropout_seed=RING_SEED,
                    head_offset=RING_HEAD_OFFSET)
    *_, ferr, berr = _partial_holds(
        f"ring_flash diagonal block at dropout {RING_DROPOUT} head_offset "
        f"{RING_HEAD_OFFSET} b={b} h={h} s={sc}", q, k, v,
        _sin_grads(q, k, v, ddrop_kw), ddrop_kw, _sin_cotangents)
    del o_live, lse_live, o_f, lse_f, gf, o_m, lse_m, q, k, v
    free_memory()

    rb, rh, rs, rd = RING_READBACK
    rkw = dict(q_offset=rs, k_offset=rs, dropout_rate=RING_DROPOUT,
               dropout_seed=RING_READBACK_SEED, head_offset=RING_HEAD_OFFSET)
    want = rand_keep_global((rb, rh, rs, rs), RING_READBACK_SEED,
                            RING_DROPOUT, head_offset=RING_HEAD_OFFSET,
                            q_offset=rs, k_offset=rs, device=dev)
    drop = _partial_drop(RING_DROPOUT, RING_READBACK_SEED, rs, rs,
                         RING_HEAD_OFFSET)
    ties = sum(int((_coord_hash24(bi, rh, rs, rs, drop, dev)
                    == drop.threshold).sum()) for bi in range(rb))
    got = _readback_keep_partial(dev, rb, rh, rs, rd, rkw)
    wrong = [int((m != want).sum()) for m in got]
    ok = not any(wrong) and ties > 0
    log(f"kernel partial dropout keep masks read back at b={rb} h={rh} s={rs} "
        f"d={rd} (q_offset=k_offset={rs}, head_offset {RING_HEAD_OFFSET}, seed "
        f"{RING_READBACK_SEED}, rate {RING_DROPOUT}): forward, dQ and dK/dV "
        f"passes against rand_keep_global, pairs that differ {wrong} of "
        f"{want.numel()} ({float(want.float().mean()):.5f} kept; {ties} pairs "
        f"on the threshold) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the partial kernels' keep masks differ from "
                             "rand_keep_global (or no pair tests the "
                             "threshold)")
    entries["flash_attention_partial_dropout"]["diagonal"] = dict(
        shape=f"b={b} h={h} s={sc} d={d} q_offset=k_offset={sc}",
        max_abs_err=max(ferr, berr))
    del got, want
    free_memory()
    return counts, entries


def flash_qkv(dev):
    """``flash_attention_qkv`` (rows 7 and 9) at GPT-345M's attention (b=8
    h=16 s=1024 d=64 causal) and BERT-large's (b=16 h=16 s=512 d=64, its
    padding mask with one all-pad row), bf16: forward and backward under
    autograd with launch counts reset just before and held exactly; then
    o and dqkv bitwise equal to ``flash_attention`` and its backward on
    ``qkv[0]``, ``qkv[1]``, ``qkv[2]`` (the same kernels), held against
    the plain versions, and timed with SDPA as the library column.
    Returns (counts, entries)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention_backward,
                                    flash_attention_backward_reference,
                                    flash_attention_qkv,
                                    flash_attention_qkv_reference,
                                    flash_attention_with_lse, launch_counts,
                                    mha_reference, reset_launch_counts)

    g = torch.Generator(device=dev)
    g.manual_seed(13)
    cases = []
    for b, h, s, d, causal, masked in QKV_CASES:
        qkv = torch.randn(3, b, h, s, d, generator=g, device=dev).bfloat16()
        do = torch.randn(b, h, s, d, generator=g, device=dev).bfloat16()
        kv = bert_mask(dev, g, dead_row=True).float() if masked else None
        cases.append((qkv, do, kv, causal))
    torch.cuda.synchronize()
    reset_launch_counts()
    runs = []
    for qkv, do, kv, causal in cases:
        t = qkv.clone().requires_grad_(True)
        o = flash_attention_qkv(t, causal=causal, kv_mask=kv)
        o.backward(do)
        runs.append((o.detach(), t.grad))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want.update(flash_attention_qkv=len(cases),
                flash_attention_qkv_bwd=len(cases))
    log(f"flash_qkv: {len(cases)} calls forward and backward; launch counts "
        f"{ {n: c for n, c in counts.items() if c} } (expected "
        f"{ {n: c for n, c in want.items() if c} })")
    if counts != want:
        raise AssertionError(f"flash_qkv launch counts {counts} != {want}")
    out = []
    for (qkv, do, kv, causal), (o, dqkv), (b, h, s, d, _, _) in zip(
            cases, runs, QKV_CASES):
        shape = (f"b={b} h={h} s={s} d={d} "
                 f"{'causal' if causal else 'kv_mask, one all-pad row'} bf16")
        views = qkv.unbind(0)
        o_s, lse = flash_attention_with_lse(*views, causal=causal, kv_mask=kv)
        grads_s = flash_attention_backward(*views, o_s, lse, do,
                                           causal=causal, kv_mask=kv)
        same = torch.equal(o, o_s) and all(
            torch.equal(a, b_) for a, b_ in zip(dqkv.unbind(0), grads_s))
        log(f"kernel flash_attention_qkv {shape}: o and dqkv bitwise equal "
            f"to flash_attention on the views: {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError("flash_attention_qkv differs from "
                                 "flash_attention on qkv's views")
        del o_s, grads_s
        o_r, lse_r = mha_reference(*views, causal=causal, return_lse=True,
                                   kv_mask=kv)
        err, lerr = _hold_forward(f"kernel flash_attention_qkv {shape}", o,
                                  o_r, lse, lse_r)
        del o_r, lse_r
        want = flash_attention_backward_reference(*views, o, lse, do,
                                                  causal=causal, kv_mask=kv)
        berr = _hold_backward(f"flash_attention_qkv_bwd {shape}",
                              dqkv.unbind(0), want)
        del want
        t = qkv.clone().requires_grad_(True)
        o_t = flash_attention_qkv(t, causal=causal, kv_mask=kv)
        fms, fms_w = time_ms(lambda: flash_attention_qkv(
            qkv, causal=causal, kv_mask=kv))
        bms, bms_w = time_ms(lambda: torch.autograd.grad(
            o_t, t, do, retain_graph=True))
        pf, _ = time_ms(lambda: flash_attention_qkv_reference(
            qkv, causal=causal, kv_mask=kv), iters=5)
        pb, _ = time_ms(lambda: flash_attention_backward_reference(
            *views, o, lse, do, causal=causal, kv_mask=kv), iters=5)
        am = None if kv is None else (kv > 0)[:, None, None, :]
        qc, kc, vc = (x.contiguous() for x in views)
        lf, _ = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=am, is_causal=causal))
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (qc, kc, vc))
        out_s = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am,
                                               is_causal=causal)
        lb, _ = time_ms(lambda: torch.autograd.grad(
            out_s, (qs, ks, vs), do, retain_graph=True))
        del out_s, qs, ks, vs, o_t, t
        fb, fby = _attn_bound(b, h, s, d, causal, False, kv)
        bb, bby = _attn_bound(b, h, s, d, causal, True, kv)
        log(f"  time {shape}, device ms (wall ms per call): forward kernel "
            f"{fms:.5f} ({fms_w:.5f}), plain {pf:.5f}, SDPA {lf:.5f}, bound "
            f"{fb:.5f} ({fby}); backward kernel {bms:.5f} ({bms_w:.5f}), "
            f"plain {pb:.5f}, SDPA backward {lb:.5f}, bound {bb:.5f} ({bby})")
        out.append((dict(name="flash_attention_qkv", shape=shape,
                         max_abs_err=max(err, lerr), ms=fms, ms_wall=fms_w,
                         plain_ms=pf, bound_ms=fb, bound_by=fby,
                         library_ms=lf),
                    dict(name="flash_attention_qkv_bwd", shape=shape,
                         max_abs_err=berr, ms=bms, ms_wall=bms_w,
                         plain_ms=pb, bound_ms=bb, bound_by=bby,
                         library_ms=lb)))
        free_memory()
    (fwd, bwd), (fwd_m, bwd_m) = out
    fwd["kvmask"], bwd["kvmask"] = fwd_m, bwd_m
    return counts, {"flash_attention_qkv": fwd, "flash_attention_qkv_bwd": bwd}


def _mha_modules(dev):
    """The two modules at ``MHA_EMBED`` and ``MHA_HEADS``, bf16, each with
    a bf16 and an fp32 twin on the plain versions (``kernels=False``)
    holding the same seeded weights (biases and LayerNorm perturbed off
    their zero and one init, so a wrong route shows)."""
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)

    torch.manual_seed(14)
    mods = []
    for cls, kw in ((SelfMultiheadAttn, dict(bias=True)),
                    (EncdecMultiheadAttn, dict(bias=True,
                                               include_norm_add=True))):
        m = cls(MHA_EMBED, MHA_HEADS, dtype=torch.bfloat16, device=dev, **kw)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.1 * torch.randn_like(p))
        twins = []
        for dtype in (torch.bfloat16, torch.float32):
            t = cls(MHA_EMBED, MHA_HEADS, dtype=dtype, device=dev,
                    kernels=False, **kw)
            t.load_state_dict(m.state_dict())
            twins.append(t)
        mods.append((m, *twins))
    return mods


def _key_bias_apart(grads, heads):
    """``grads`` (name -> gradient) with the key projection's bias
    gradient taken out of ``din_proj_bias`` ([head][q|k|v] lanes) and
    ``din_proj_bias_kv`` ([head][k|v]) into ``dkey_bias``."""
    out = dict(grads)
    keys = []
    for name, parts, k in (("din_proj_bias", 3, 1), ("din_proj_bias_kv", 2, 0)):
        if name in out:
            g = out[name].reshape(heads, parts, -1)
            keys.append(g[:, k].flatten())
            out[name] = torch.cat([g[:, i] for i in range(parts) if i != k],
                                  1).flatten()
    if keys:
        out["dkey_bias"] = torch.cat(keys)
    return out


def _mha_step(mod, xs, kw, ct):
    """One forward and backward of ``mod``: (out, input grads, parameter
    grads by name)."""
    mod.zero_grad(set_to_none=True)
    ts = [x.clone().requires_grad_(True) for x in xs]
    out, _ = mod(*ts, is_training=False, **kw)
    (out.float() * ct).sum().backward()
    return out.detach(), [t.grad for t in ts], \
        {n: p.grad for n, p in mod.named_parameters()}


def multihead_attn(dev):
    """``contrib.multihead_attn`` at GPT-345M width (embed 1024, 16 heads,
    bf16), forward and backward (loss sum(out * ct)):
    ``SelfMultiheadAttn`` (bias) at b=16 s=512 with BERT's padding mask
    and one all-pad row as key_padding_mask (the E kernels' kv_mask lanes,
    rows 10/12) and with the causal time mask (rows 10/12), and
    ``EncdecMultiheadAttn`` (bias, include_norm_add) at b=16 tq=256
    tk=512 with a padding mask (the (b, h, s, d) kv_mask lane, rows 6/8,
    and LayerNorm, rows 1/2); launch counts reset just before the three
    steps and held exactly.  Each step's output, input gradients and
    parameter gradients held, with the same module's bf16 run on the
    plain versions, against its fp32 run on them (``MHA_ERR_RATIO``,
    ``MHA_ERR_FLOOR``), and timed beside the bf16 plain run; then the
    kv_mask lane of rows 6/8 alone at the encdec shape, held element by
    element and timed with SDPA under the boolean mask.  Returns (counts,
    entries)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention_backward,
                                    flash_attention_backward_reference,
                                    flash_attention_with_lse, launch_counts,
                                    mha_reference, reset_launch_counts)

    g = torch.Generator(device=dev)
    g.manual_seed(14)
    (self_m, self_p, self_f), (enc_m, enc_p, enc_f) = _mha_modules(dev)
    e = MHA_EMBED
    b, s = MHA_SELF
    bq, tq, tk = MHA_ENCDEC
    x = torch.randn(s, b, e, generator=g, device=dev).bfloat16()
    kpm = bert_mask(dev, g, dead_row=True) == 0          # 1 = padding
    causal = ~torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    xq = torch.randn(tq, bq, e, generator=g, device=dev).bfloat16()
    mem = torch.randn(tk, bq, e, generator=g, device=dev).bfloat16()
    kpm_e = bert_mask(dev, g) == 0
    ct = torch.randn(s, b, e, generator=g, device=dev)
    ct_e = torch.randn(tq, bq, e, generator=g, device=dev)
    steps = (("SelfMultiheadAttn key_padding_mask", (self_m, self_p, self_f),
              (x,), dict(key_padding_mask=kpm), ct),
             ("SelfMultiheadAttn causal attn_mask", (self_m, self_p, self_f),
              (x,), dict(attn_mask=causal), ct),
             ("EncdecMultiheadAttn key_padding_mask include_norm_add",
              (enc_m, enc_p, enc_f), (xq, mem), dict(key_padding_mask=kpm_e),
              ct_e))
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [_mha_step(ms[0], xs, kw, c) for _, ms, xs, kw, c in steps]
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want.update({name: 1 for name in MHA_KERNELS})
    log(f"multihead_attn: 3 module steps forward and backward; launch "
        f"counts { {n: c for n, c in counts.items() if c} } (expected "
        f"{ {n: c for n, c in want.items() if c} })")
    if counts != want:
        raise AssertionError(f"multihead_attn launch counts {counts} != "
                             f"{want}")
    def flat(run):
        out, gx, gp = run
        return _key_bias_apart(dict(
            [("out", out)] + [(f"d{n}", a) for n, a in zip(("query", "key"),
                                                          gx)]
            + [(f"d{n}", a) for n, a in gp.items()]), MHA_HEADS)

    for (label, (m, p, f), xs, kw, c), run in zip(steps, got):
        kern, plain = flat(run), flat(_mha_step(p, xs, kw, c))
        ref = flat(_mha_step(f, [t.float() for t in xs], kw, c))

        def err(a, n):
            r = ref[n].float()
            return float((a.float() - r).norm() / r.norm().clamp_min(1e-30))

        kb = [float(t["dkey_bias"].float().norm()) for t in (kern, plain, ref)]
        errs = {n: (err(kern[n], n), err(plain[n], n)) for n in ref
                if n != "dkey_bias"}
        bad = [n for n, (ek, ep) in errs.items()
               if not ek <= MHA_ERR_RATIO * ep + MHA_ERR_FLOOR]
        finite = all(bool(torch.isfinite(a).all()) for a in kern.values())
        worst = max(errs, key=lambda n: errs[n][0] / (errs[n][1]
                                                      + MHA_ERR_FLOOR))
        vs_plain = max(float((kern[n].float() - plain[n].float()).norm()
                             / ref[n].float().norm().clamp_min(1e-30))
                       for n in errs)
        ok = finite and not bad
        km, _ = time_ms(lambda: _mha_step(m, xs, kw, c), iters=10)
        pm, _ = time_ms(lambda: _mha_step(p, xs, kw, c), iters=5)
        log(f"multihead_attn {label} (embed {e}, {MHA_HEADS} heads, bf16): "
            f"the output and {len(errs) - 1} gradients against an fp32 run of "
            f"the plain versions, ||err|| / ||ref|| of the kernels at most "
            f"{MHA_ERR_RATIO} x the bf16 plain twin's + {MHA_ERR_FLOOR}: "
            f"worst {worst} {errs[worst][0]:.3e} (plain {errs[worst][1]:.3e})"
            f"{', failing ' + str(bad) if bad else ''}; kernels vs plain twin "
            f"at most {vs_plain:.3e}; the key bias's gradient (0 "
            f"analytically), ||.|| kernels {kb[0]:.3e}, plain {kb[1]:.3e}, "
            f"fp32 {kb[2]:.3e}; finite {finite}; forward and backward "
            f"device ms: kernels {km:.5f}, plain {pm:.5f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"multihead_attn {label} disagrees with its "
                                 f"plain version")
    del got, steps
    free_memory()

    # the (b, h, s, d) kv_mask lane alone at the encdec shape
    h, d = MHA_HEADS, e // MHA_HEADS
    kvm = (~kpm_e).float()
    q = torch.randn(bq, h, tq, d, generator=g, device=dev).bfloat16()
    k, v = (torch.randn(bq, h, tk, d, generator=g, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn(bq, h, tq, d, generator=g, device=dev).bfloat16()
    shape = (f"b={bq} h={h} sq={tq} sk={tk} d={d} kv_mask "
             f"({int(kvm.sum())} of {bq * tk} keys live) bf16")
    o, lse = flash_attention_with_lse(q, k, v, kv_mask=kvm)
    torch.cuda.synchronize()
    o_r, lse_r = mha_reference(q, k, v, return_lse=True, kv_mask=kvm)
    err, lerr = _hold_forward(f"kernel flash_attention_kvmask {shape}", o,
                              o_r, lse, lse_r)
    grads = flash_attention_backward(q, k, v, o, lse, do, kv_mask=kvm)
    torch.cuda.synchronize()
    berr = _hold_backward(f"flash_attention_bwd_kvmask {shape}", grads,
                          flash_attention_backward_reference(
                              q, k, v, o, lse, do, kv_mask=kvm))
    masked_zero = bool((grads[1][~(kvm > 0)[:, None, :, None]
                               .expand_as(grads[1])] == 0).all())
    if not masked_zero:
        raise AssertionError("flash_attention_bwd_kvmask: a masked key took "
                             "a gradient")
    fms, fms_w = time_ms(lambda: flash_attention_with_lse(q, k, v,
                                                          kv_mask=kvm))
    bms, bms_w = time_ms(lambda: flash_attention_backward(
        q, k, v, o, lse, do, kv_mask=kvm))
    pf, _ = time_ms(lambda: mha_reference(q, k, v, return_lse=True,
                                          kv_mask=kvm), iters=10)
    pb, _ = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, o, lse, do, kv_mask=kvm), iters=10)
    am = (kvm > 0)[:, None, None, :]
    lf, _ = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=am))
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out_s = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am)
    lb, _ = time_ms(lambda: torch.autograd.grad(
        out_s, (qs, ks, vs), do, retain_graph=True))
    pairs = float(h * tq * kvm.sum())
    fb, fby = _flash_bound(bq, h, tq, tk, d, pairs, False, bq * tk * 4)
    bb, bby = _flash_bound(bq, h, tq, tk, d, pairs, True, bq * tk * 4)
    log(f"  time {shape}, device ms (wall ms per call): forward kernel "
        f"{fms:.5f} ({fms_w:.5f}), plain {pf:.5f}, SDPA with the boolean "
        f"(b, 1, 1, sk) mask {lf:.5f}, bound {fb:.5f} ({fby}); backward "
        f"kernel {bms:.5f} ({bms_w:.5f}), plain {pb:.5f}, SDPA backward "
        f"{lb:.5f}, bound {bb:.5f} ({bby})")
    del out_s, qs, ks, vs
    free_memory()
    return counts, {
        "flash_attention_kvmask": dict(
            name="flash_attention_kvmask", shape=shape,
            max_abs_err=max(err, lerr), ms=fms, ms_wall=fms_w, plain_ms=pf,
            bound_ms=fb, bound_by=fby, library_ms=lf),
        "flash_attention_bwd_kvmask": dict(
            name="flash_attention_bwd_kvmask", shape=shape, max_abs_err=berr,
            ms=bms, ms_wall=bms_w, plain_ms=pb, bound_ms=bb, bound_by=bby,
            library_ms=lb)}


def profile_zero_adam(dev) -> None:
    """One step of each side of bench_zero_adam's pair under
    ``torch.profiler`` (parameters, state and two steps outside the
    window): device time by kernel, the Adam kernel's share and the idle
    share of the step's wall."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.contrib.optimizers import distributed_fused_adam
    from apex_tpu_torch.optimizers import fused_adam

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for label, make in (("dense", lambda: fused_adam(ZERO_LR)),
                            ("sharded", lambda: distributed_fused_adam(
                                ZERO_LR))):
            p, g = _seeded_leaves(dev, 12, ZERO_SHAPES)
            tx = make()
            holder = [tx.init(p)]
            for _ in range(2):
                _update_step(tx, p, g, holder)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _update_step(tx, p, g, holder)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            rows = _profile_rows(prof)
            busy = sum(r[1] for r in rows)
            if busy <= 0:
                raise AssertionError("zero_adam profile: no device time")
            adam = sum(ms for name, ms, _ in rows if "update_kernel" in name)
            log(f"zero_adam profile ({label}, one step, profiler on): wall "
                f"{wall:.3f} ms, device busy {busy:.3f} ms summed over "
                f"kernels ({100 - 100 * busy / wall:.2f}% idle); the Adam "
                f"update kernel {adam:.3f} ms ({100 * adam / busy:.2f}%)")
            for name, ms, cnt in rows[:10]:
                log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{cnt:<6d} "
                    f"{name[:90]}")
            del p, g, holder, tx
            free_memory()
    finally:
        dist.destroy_process_group()


def profile_resnet(dev) -> None:
    """One staged O5 step of bench_resnet50 under ``torch.profiler``
    (built and two steps taken outside the window): device time by kernel
    and by part (cuDNN convolutions and the fc GEMM, the max pool, the
    optimizer kernel, the plain batch norm and the other elementwise
    work), and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.examples.imagenet import main_amp

    setup = _resnet_setup(dev)
    for _ in range(2):
        main_amp.train_step(setup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(main_amp.train_step(setup)[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof)
    busy = sum(r[1] for r in rows)
    # max pool first: ATen's channels-last pool kernels end in "_nhwc"
    conv_marks = ("xmma", "cudnn", "conv", "implicit", "cutlass", "dgrad",
                  "wgrad", "fprop", "gemm")
    parts = {"optimizer (sgd_leaves_kernel)": 0.0,
             "cuDNN convolutions and the fc GEMM": 0.0, "max pool": 0.0,
             "batch norm, ReLU, casts, loss (plain)": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "sgd_leaves_kernel" in name:
            parts["optimizer (sgd_leaves_kernel)"] += ms
        elif "max_pool" in low:
            parts["max pool"] += ms
        elif any(k in low for k in conv_marks):
            parts["cuDNN convolutions and the fc GEMM"] += ms
        else:
            parts["batch norm, ReLU, casts, loss (plain)"] += ms
    log(f"train_resnet profile (staged O5, one step, profiler on): wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms summed over kernels "
        f"({100 * busy / wall:.2f}% of the wall, so "
        f"{100 - 100 * busy / wall:.2f}% idle); by part: "
        + "; ".join(f"{k} {v:.3f} ms ({100 * v / busy:.2f}%)"
                    for k, v in parts.items()))
    for name, ms, n in rows[:18]:
        log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{n:<6d} "
            f"{name[:90]}")
    del setup
    free_memory()


def _profile_rows(prof):
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows


def check_moe_launches(dev, calls: int = 10) -> None:
    """Row 18's CUDA launches a call, read under one ``torch.profiler``
    window over ``calls`` calls at each of ``MOE_CASES``' shapes: every
    device kernel those calls start, told apart by name (the one-launch
    dispatch at T <= ``MOE_ONE_LAUNCH_T``; above, the route and the
    two-launch dispatch), and nothing else.  Run first among the
    profiles: in a window after earlier ones the profiler has dropped
    some kernels' records (73 of 80, or all of them)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops.moe_routing import _fused

    g = torch.Generator(device=dev)
    g.manual_seed(14)
    args = []
    for label, t, h, ne, cap, k, pol, dt in MOE_CASES:
        x = torch.randn(t, h, generator=g, device=dev).to(dt)
        logits = torch.randn(t, ne, generator=g, device=dev)
        u = torch.rand(t, generator=g, device=dev) if pol == "random" \
            else None
        args.append((x, logits, u, dict(capacity=cap, top_k=k,
                                         second_policy=pol)))
        _fused(x, logits, u, **args[-1][3])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x, logits, u, kw in args:
            for _ in range(calls):
                _fused(x, logits, u, **kw)
        torch.cuda.synchronize()
    got = {"one": 0, "route": 0, "two": 0, "other": 0}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        kind = ("route" if "route_kernel" in e.key else
                "one" if "dispatch_kernel" in e.key and ", true>" in e.key
                else "two" if "dispatch_kernel" in e.key else "other")
        got[kind] += e.count
    n_one = sum(t <= MOE_ONE_LAUNCH_T for _, t, *_ in MOE_CASES)
    n_two = len(MOE_CASES) - n_one
    want = {"one": calls * n_one, "route": calls * n_two,
            "two": calls * n_two, "other": 0}
    ok = got == want
    log(f"moe_route_dispatch launches over {calls} calls at each of "
        f"{len(MOE_CASES)} shapes ({n_one} at T <= {MOE_ONE_LAUNCH_T}): "
        f"{got} (want {want}: one launch a call at T <= "
        f"{MOE_ONE_LAUNCH_T}, two above) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"moe_route_dispatch launch counts {got} != "
                             f"{want}")


def profile_train(dev, policy: str = "O5", family: str = "gpt"):
    """One train step in ``policy``'s recipe under ``torch.profiler``
    (model built and two steps taken outside the window): device time by
    kernel, launches, and the device's idle share of the step's wall.
    For O2 also the fp32 GEMMs' share (the attention scores from fp16 q
    and k, upcast: cuBLAS kernels whose name marks fp32 operands)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops import launch_counts, reset_launch_counts

    mod, model = _train_module(family)
    make_train_setup, train_step = mod.make_train_setup, mod.train_step
    # BERT on bench.py's own batch, the all-ones mask
    full = dict(full_mask=True) if family == "bert" else {}
    setup = make_train_setup(model, policy=policy, seed=0, device=dev,
                             **full, **TRAIN_KW.get(family, {}))
    for _ in range(2):
        train_step(setup)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(train_step(setup)[0])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    rows = _profile_rows(prof)
    busy = sum(r[1] for r in rows)
    drop = TRAIN_KW.get(family, {}).get("attention_dropout")
    log(f"train profile ({model} {policy}{', all-ones mask' if full else ''}"
        f"{f', attention dropout {drop}' if drop else ''}"
        f", one step, profiler on): step "
        f"wall {wall:.3f} ms, device busy {busy:.3f} ms summed over kernels "
        f"({100 * busy / wall:.2f}% of the wall, so "
        f"{100 - 100 * busy / wall:.2f}% idle); port launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for name, ms, n in rows[:18]:
        log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{n:<6d} "
            f"{name[:90]}")
    if policy == "O2":
        fp32 = [(k, ms, n) for k, ms, n in rows
                if "sgemm" in k or "f32f32_f32f32" in k]
        total = sum(ms for _, ms, _ in fp32)
        layers = mod.MODELS[model]["num_layers"]
        log(f"train profile ({model} O2): fp32 GEMM kernels {total:.3f} "
            f"ms in {sum(n for _, _, n in fp32)} launches "
            f"({total / layers:.3f} ms a layer, {100 * total / busy:.2f}% "
            f"of device time): "
            + "; ".join(f"{k[:60]} x{n}" for k, _, n in fp32[:4]))
    del setup
    free_memory()


def profile_recipe(dev) -> None:
    """One step of the staged recipe (materialized scores) with
    checkpointing on and off under ``torch.profiler`` (model built and
    two steps taken outside the window): the step's wall, device busy
    and idle share, and the leading kernels: where checkpointing's cost
    lies."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.testing.standalone_bert import train_step

    for ckpt in (True, False):
        setup, _ = recipe_setup(dev, checkpoint=ckpt)
        for _ in range(2):
            train_step(setup)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(train_step(setup)[0])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = _profile_rows(prof)
        busy = sum(r[1] for r in rows)
        log(f"train_bert_recipe profile (staged, checkpointing "
            f"{'on' if ckpt else 'off'}, one step, profiler on): wall "
            f"{wall:.3f} ms, device busy {busy:.3f} ms ("
            f"{100 - 100 * busy / wall:.2f}% idle)")
        for name, ms, n in rows[:12]:
            log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{n:<6d} "
                f"{name[:90]}")
        del setup
        free_memory()


def profile_serve(dev, model: str = "gpt345m", policy: str = "O5",
                  kv_dtype: str = "model", moe_experts: int = 0,
                  moe_capacity_factor: float = MOE_NODROP_CF, **fast):
    """The serve's ``engine.run()`` once more under ``torch.profiler``
    (weights and engine built outside the window) at ``policy`` (O5, or
    Q8 with its quantized weights) over a ``kv_dtype`` cache, plain or
    with the fast-path options ``fast`` (a self draft when speculating),
    or with every layer a ``moe_experts``-way MoE at
    ``moe_capacity_factor``:
    device busy share of the run's wall, and device time by kernel."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import (Request, ServingEngine,
                                        default_cache_config,
                                        init_serving_weights,
                                        quantize_weights)
    from apex_tpu_torch.testing.standalone_gpt import (model_config,
                                                       moe_serving_weights,
                                                       seeded_prompts)

    cfg = model_config(model, policy=policy)
    weights = init_serving_weights(cfg, seed=0, device=dev)
    if policy == "Q8":
        weights = quantize_weights(weights)
    if moe_experts:
        cfg = dataclasses.replace(cfg, num_experts=moe_experts,
                                  moe_capacity_factor=moe_capacity_factor)
        weights = moe_serving_weights(weights, moe_experts, 2)
    label = ", ".join([policy] + ([f"kv {kv_dtype}"] if kv_dtype != "model"
                                 else []) + ([f"{fast}"] if fast else [])
                      + ([f"MoE {moe_experts} experts cf "
                          f"{moe_capacity_factor}"] if moe_experts else []))
    if fast.get("speculate_k"):
        fast = dict(fast, draft_weights=weights, draft_cfg=cfg)
    engine = ServingEngine(weights, cfg,
                           default_cache_config(cfg, kv_dtype=kv_dtype),
                           device=dev, **fast)
    for i, p in enumerate(seeded_prompts(SERVE_LENGTHS, cfg.vocab_size,
                                         seed=2)):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _profile_rows(prof)
    busy = sum(r[1] for r in rows)
    log(f"serve profile ({label}, profiler on): {engine.steps} ticks, run "
        f"wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms summed over kernels ({100 * busy / wall:.2f}% "
        f"of the run wall, so {100 - 100 * busy / wall:.2f}% idle)")
    for name, ms, n in rows[:14]:
        log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{n:<6d} "
            f"{name[:90]}")


PHASES = ("kernels", "serve", "serve_fast", "serve_q8", "serve_moe", "train",
          "train_o2", "train_bert", "train_bert_o2", "train_bert_recipe",
          "long_context", "train_long", "train_dropout", "train_resnet",
          "resnet_faults", "zero_adam", "optim_update", "ring_flash",
          "flash_qkv", "multihead_attn", "profile", "dropout_faults",
          "recipe_faults", "numerics")
# every phase but the planted dropout faults (two rebuilds of the flash
# sources), the recipe's planted loss faults and the forward's numerics,
# which run only when named
DEFAULT_PHASES = tuple(p for p in PHASES
                       if p not in ("dropout_faults", "recipe_faults",
                                    "numerics"))


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help=f"comma-separated subset of {PHASES} (build "
                         f"always runs; the default all but "
                         f"dropout_faults and numerics); the result lines "
                         f"print only when all of the default run")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phase in {sorted(phases)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    try:
        import apex_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              f"from the repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    # the caching allocator starts with the first allocation; the memory
    # statistics the train phase resets need it, whatever phase runs first
    torch.zeros((), device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    failed = []
    entries = {}
    counts = {}
    plain_serve = None

    def run(what, fn):
        try:
            return True, fn()
        except Exception:
            traceback.print_exc()
            failed.append(what)
            free_memory()
            return False, None

    try:
        smi = nvidia_smi()
        log(smi)
    except Exception as e:  # the line is part of the contract
        smi = None
        failed.append(f"nvidia-smi: {e}")
    run("build", phase_build)
    if not failed:
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        gq = torch.Generator(device=dev)
        gq.manual_seed(5)
        gb = torch.Generator(device=dev)
        gb.manual_seed(6)
        gl = torch.Generator(device=dev)
        gl.manual_seed(7)
        gm = torch.Generator(device=dev)
        gm.manual_seed(8)
        gr = torch.Generator(device=dev)
        gr.manual_seed(9)
        gd = torch.Generator(device=dev)
        gd.manual_seed(10)
        gu = torch.Generator(device=dev)
        gu.manual_seed(11)
        if "kernels" in phases:
            for name, fn in (("layer_norm", check_layer_norm),
                             ("flash_attention", check_flash_attention),
                             ("flash_decode", check_flash_decode),
                             ("flash_decode_multi",
                              check_flash_decode_multi),
                             ("flash_decode_int8", functools.partial(
                                 check_flash_decode, int8=True)),
                             ("flash_decode_multi_int8", functools.partial(
                                 check_flash_decode_multi, int8=True)),
                             ("quant_matmul", check_quant_matmul),
                             ("layer_norm_bwd", check_layer_norm_bwd),
                             ("flash_attention_e", check_flash_attention_e),
                             ("fused_adam_pipeline", check_fused_adam),
                             ("scaled_softmax", check_scaled_softmax),
                             ("norm_finite", check_norm_finite),
                             ("grad_routing", check_grad_routing),
                             ("scaled_masked_softmax", check_masked_softmax),
                             ("flash_attention_e_kvmask",
                              check_flash_attention_e_kvmask),
                             ("lamb_phase1", check_lamb_phase1),
                             ("flash_attention_bwd",
                              check_flash_attention_bwd),
                             ("flash_attention_e_long",
                              check_flash_attention_e_long),
                             ("moe_routing", check_moe_routing),
                             ("sgd_step", check_sgd_step),
                             ("adam_step", check_adam_step),
                             ("sgd_pipeline", check_sgd_pipeline),
                             ("flash_attention_e_dropout",
                              check_flash_attention_e_dropout),
                             ("optim_update", check_optim_update)):
                # the Q8 tier's, the BERT phases', the long-context, MoE,
                # ResNet, dropout and update slices' checks draw from
                # generators of their own, so the earlier checks see the
                # inputs they saw before
                gen = gq if name in Q8_CHECKS else \
                    gb if name in BERT_CHECKS else \
                    gl if name in LONG_CHECKS else \
                    gm if name in MOE_CHECKS else \
                    gr if name in RESNET_CHECKS else \
                    gd if name in DROPOUT_CHECKS else \
                    gu if name in UPDATE_CHECKS else g
                ok, out = run(f"kernel {name}", lambda: fn(dev, gen))
                if ok and out is not None:
                    for e in (out if isinstance(out, tuple) else (out,)):
                        # a sub-entry of an earlier entry: (name, key)
                        of = e.pop("of", None)
                        if name == "layer_norm_bwd" and \
                                e["name"] == "layer_norm":
                            of = ("layer_norm", "train")
                        if of is not None:
                            if of[0] in entries:
                                entries[of[0]][of[1]] = e
                        else:
                            entries[e["name"]] = e
                free_memory()
            ok, out = run("kernel fp16 builds",
                          lambda: check_fp16_builds(dev, g))
            if ok:
                for name, e in out.items():
                    if name in entries:
                        entries[name]["fp16"] = e
            free_memory()
        if "serve" in phases:
            ok, out = run("serve O5", lambda: serve_and_check(
                dev, policy="O5", gap_tol=TOKEN_GAP_TOL, counted=True))
            if ok:
                counts["serve"], *plain_serve = out
            run("serve O0", lambda: serve_and_check(
                dev, policy="O0", gap_tol=TOKEN_GAP_TOL_FP32))
            free_memory()
        if "serve_fast" in phases:
            legs = []
            for name, fn in serve_fast_legs(plain_serve):
                ok, out = run(f"serve_fast {name}", lambda: fn(dev))
                legs.append(out if ok else None)
                free_memory()
            if all(c is not None for c in legs):
                counts["serve_fast"] = {k: sum(c[k] for c in legs)
                                        for k in legs[0]}
                log(f"serve_fast: launch counts over the five legs "
                    f"{ {k: v for k, v in counts['serve_fast'].items() if v} }")
                if any(counts["serve_fast"][k] <= 0
                       for k in SERVE_FAST_KERNELS):
                    failed.append("serve_fast: a kernel of the path never "
                                  "launched")
        if "serve_q8" in phases:
            legs = []
            for name, fn in serve_q8_legs():
                ok, out = run(f"serve_q8 {name}", lambda: fn(dev))
                legs.append(out if ok else None)
                free_memory()
            if all(c is not None for c in legs):
                counts["serve_q8"] = {k: sum(c[k] for c in legs)
                                      for k in legs[0]}
                log(f"serve_q8: launch counts over the three legs "
                    f"{ {k: v for k, v in counts['serve_q8'].items() if v} }")
                if any(counts["serve_q8"][k] <= 0 for k in SERVE_Q8_KERNELS):
                    failed.append("serve_q8: a kernel of the path never "
                                  "launched")
        if "serve_moe" in phases:
            legs = []
            for name, fn in serve_moe_legs():
                ok, out = run(f"serve_moe {name}", lambda: fn(dev))
                legs.append(out if ok else None)
                free_memory()
            if all(c is not None for c in legs):
                counts["serve_moe"] = {k: sum(c[k] for c in legs)
                                       for k in legs[0]}
                log(f"serve_moe: launch counts over the two legs "
                    f"{ {k: v for k, v in counts['serve_moe'].items() if v} }")
                if any(counts["serve_moe"][k] <= 0
                       for k in SERVE_MOE_KERNELS):
                    failed.append("serve_moe: a kernel of the path never "
                                  "launched")
        train_ms = None
        if "train" in phases:
            ok, out = run("train O5", lambda: train_and_check(dev))
            if ok:
                counts["train"], kernel_losses, _, train_ms = out
                run("train plain", lambda: train_plain_and_compare(
                    dev, kernel_losses[:PLAIN_STEPS]))
        if "train_o2" in phases:
            ok, out = run("train O2", lambda: train_and_check(dev, "O2"))
            if ok:
                counts["train_o2"], o2_losses, o2_steps, _ = out
                run("train O2 plain", lambda: train_plain_and_compare(
                    dev, o2_losses[:PLAIN_STEPS], "O2",
                    o2_steps[:PLAIN_STEPS]))
            run("train O2 overflow", lambda: overflow_leg(dev))
        for phase, policy in (("train_bert", "O5"), ("train_bert_o2", "O2")):
            if phase not in phases:
                continue
            ok, out = run(phase, lambda: train_and_check(dev, policy,
                                                         "bert"))
            if ok:
                counts[phase], b_losses, b_steps, _ = out
                run(f"{phase} plain", lambda: train_plain_and_compare(
                    dev, b_losses[:PLAIN_STEPS], policy,
                    b_steps[:PLAIN_STEPS] if policy == "O2" else None,
                    family="bert"))
                run(f"{phase} all-ones mask", lambda: train_bert_full_mask(
                    dev, policy))
        if "train_bert_recipe" in phases:
            ok, out = run("train_bert_recipe",
                          lambda: train_bert_recipe(dev))
            if ok:
                counts["train_bert_recipe"] = out
            free_memory()
        if "long_context" in phases:
            ok, out = run("long_context", lambda: long_context(dev))
            if ok:
                counts["long_context"] = out
        if "train_long" in phases:
            ok, out = run("train_long", lambda: train_and_check(
                dev, "O5", "gpt_long"))
            if ok:
                counts["train_long"], long_losses, _, _ = out
                run("train_long plain", lambda: train_plain_and_compare(
                    dev, long_losses[:PLAIN_STEPS], "O5",
                    family="gpt_long"))
        if "train_dropout" in phases:
            ok, out = run("train_dropout", lambda: train_and_check(
                dev, "O5", "gpt_dropout"))
            if ok:
                counts["train_dropout"], drop_losses, _, drop_ms = out
                if train_ms is not None:
                    log(f"train_dropout: the step {drop_ms:.3f} ms against "
                        f"the dropout-free train step's {train_ms:.3f} ms in "
                        f"this run: {drop_ms / train_ms:.4f}x")
                run("train_dropout plain", lambda: train_plain_and_compare(
                    dev, drop_losses[:PLAIN_STEPS], "O5",
                    family="gpt_dropout"))
            ok, out = run("train_dropout long", lambda: train_and_check(
                dev, "O5", "gpt_dropout_long"))
            if ok:
                counts["train_dropout_long"] = out[0]
        if "train_resnet" in phases:
            ok, out = run("train_resnet", lambda: train_resnet(dev))
            if ok:
                counts["train_resnet"] = out
        if "resnet_faults" in phases:
            run("resnet_faults", lambda: resnet_faults(dev))
        if "zero_adam" in phases:
            ok, out = run("zero_adam", lambda: zero_adam(dev))
            if ok:
                counts["zero_adam"] = out
        if "optim_update" in phases:
            ok, out = run("optim_update", lambda: optim_update(dev))
            if ok:
                counts["optim_update"] = out
        for phase, fn in (("ring_flash", ring_flash),
                          ("flash_qkv", flash_qkv),
                          ("multihead_attn", multihead_attn)):
            if phase in phases:
                ok, out = run(phase, lambda: fn(dev))
                if ok:
                    counts[phase], new = out
                    entries.update(new)
                free_memory()
        if "dropout_faults" in phases:
            run("dropout_faults", lambda: dropout_faults(dev))
        if "recipe_faults" in phases:
            run("recipe_faults", lambda: recipe_faults(dev))
        if "numerics" in phases:
            run("numerics", lambda: flash_numerics(dev))
            run("numerics spread", lambda: train_spread(dev))
        if "profile" in phases:
            if "serve_moe" in phases:
                run("moe_route_dispatch launches",
                    lambda: check_moe_launches(dev))
            if "serve" in phases:
                run("serve profile", lambda: profile_serve(dev))
            if "serve_fast" in phases:
                run("serve_fast profile", lambda: profile_serve(
                    dev, speculate_k=SPEC_K))
            if "serve_q8" in phases:
                run("serve_q8 profile", lambda: profile_serve(
                    dev, policy="Q8", kv_dtype="int8"))
            if "serve_moe" in phases:
                for cf in (MOE_NODROP_CF, MOE_DROP_CF):
                    run(f"serve_moe cf {cf} profile", lambda: profile_serve(
                        dev, moe_experts=MOE_EXPERTS, moe_capacity_factor=cf))
            if "train" in phases:
                run("train profile", lambda: profile_train(dev))
            if "train_o2" in phases:
                run("train O2 profile", lambda: profile_train(dev, "O2"))
            if "train_bert" in phases:
                run("train_bert profile", lambda: profile_train(
                    dev, "O5", "bert"))
            if "train_bert_o2" in phases:
                run("train_bert O2 profile", lambda: profile_train(
                    dev, "O2", "bert"))
            if "train_bert_recipe" in phases:
                run("train_bert_recipe profile",
                    lambda: profile_recipe(dev))
            if "train_long" in phases:
                run("train_long profile", lambda: profile_train(
                    dev, "O5", "gpt_long"))
            if "train_dropout" in phases:
                run("train_dropout profile", lambda: profile_train(
                    dev, "O5", "gpt_dropout"))
            if "train_resnet" in phases:
                run("train_resnet profile", lambda: profile_resnet(dev))
            if "zero_adam" in phases:
                run("zero_adam profile", lambda: profile_zero_adam(dev))
    log(f"chip_smoke: command time {time.perf_counter() - t_start:.1f} s")
    if failed:
        log(f"chip_smoke FAILED: {failed}")
        return 1
    if not phases >= set(DEFAULT_PHASES):
        log(f"chip_smoke: phases {sorted(phases)} passed; the result lines "
            f"print only when every default phase runs")
        return 0
    kernels = []
    for name in REPLACES:
        e = dict(entries[name])
        by_path = {path: counts[path][name] for path, ks in
                   (("serve", SERVE_KERNELS),
                    ("serve_fast", SERVE_FAST_KERNELS),
                    ("serve_q8", SERVE_Q8_KERNELS),
                    ("serve_moe", SERVE_MOE_KERNELS),
                    ("train", TRAIN_KERNELS),
                    ("train_o2", TRAIN_O2_KERNELS),
                    ("train_bert", TRAIN_BERT_KERNELS),
                    ("train_bert_o2", TRAIN_BERT_O2_KERNELS),
                    ("train_bert_recipe", TRAIN_BERT_RECIPE_KERNELS),
                    ("long_context", LONG_CONTEXT_KERNELS),
                    ("train_long", TRAIN_LONG_KERNELS),
                    ("train_resnet", TRAIN_RESNET_KERNELS),
                    ("train_dropout", TRAIN_DROPOUT_KERNELS),
                    ("train_dropout_long", TRAIN_DROPOUT_LONG_KERNELS),
                    ("zero_adam", ZERO_ADAM_KERNELS),
                    ("optim_update", OPTIM_UPDATE_KERNELS),
                    ("ring_flash", RING_FLASH_KERNELS),
                    ("flash_qkv", FLASH_QKV_KERNELS),
                    ("multihead_attn", MHA_KERNELS))
                   if name in ks}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=e["max_abs_err"], ms=e["ms"], ms_wall=e["ms_wall"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            shape=e["shape"],
            **{k: e[k] for k in ("train", "fp16", "bert", "chunk", "shapes",
                                 "d128", "sweep", "kvmask", "fallback",
                                 "diagonal")
               if k in e}))
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                log(f"chip_smoke FAILED: {k['name']} {key} = {k[key]}")
                return 1
        if k["launches"] <= 0:
            log(f"chip_smoke FAILED: {k['name']} never launched on its path")
            return 1
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
