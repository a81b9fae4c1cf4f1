"""Chip smoke for the PyTorch/H100 port (``apex_tpu_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root

Phases, in order; any failure exits non-zero without the result line:

1. build         — compile every kernel under ``apex_tpu_torch/csrc``
                   (one ``nvcc`` per source, all at once) and print the
                   card's ``nvidia-smi`` name and power limit.
2. kernels       — hold each kernel against its plain PyTorch version on
                   the card, with the stated tolerances, and time kernel,
                   plain version, one library call and the card's bound:
                   LayerNorm forward, flash prefill and paged decode at
                   the serving path's shapes; LayerNorm backward, the
                   E-layout flash forward and backward, and the Adam
                   pipeline sweep at the O5 train step's shapes; the
                   causal scaled softmax forward and backward and the
                   norm/finite sweep at the O2 train step's, and the
                   fp16 builds of LayerNorm and the Adam sweep it runs.
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
4. train O5      — the same width at seq 1024, batch 8 (bench.py's
                   bench_gpt345m), O5, ``fused_adam(1e-4)``, seeded
                   weights: 8 steps through ``standalone_gpt.train_smoke``
                   with launch counts reset just before; every train
                   kernel must have launched as often as the step
                   implies, losses finite, step 8's below step 1's.
5. train plain   — the first 3 steps again from the same weights and
                   batch through every kernel's plain version (no kernel
                   may launch); each loss within ``TRAIN_LOSS_TOL`` of
                   the kernel run's.
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
7. profiles      — the O5 serve, one O5 train step and one O2 train step
                   under ``torch.profiler``: device time by kernel and
                   the device's idle share.  Last, since the profiler
                   slows every later launch.

``--phases`` runs a subset (``build`` always runs), for iterating.
The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
import traceback

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
# served token vs oracle argmax: a bf16 forward through other kernels
# and other matmul shapes moves a logit by a few hundredths at this
# width, so positions whose top-2 gap is below this are ties
TOKEN_GAP_TOL = 0.1
# the same check in fp32 (O0): kernels and plain versions agree to ~1e-6
TOKEN_GAP_TOL_FP32 = 2e-3
# LayerNorm backward, bf16 x/dy/gamma: dx like the forward (one bf16 ulp
# at |dx| up to ~4); dgamma/dbeta are sums over 8192 rows rounded once to
# bf16, so they are held relative to their largest value (2.5 ulps)
LN_BWD_TOL = 3e-2
LN_WGRAD_RTOL = 1e-2
# E-layout flash backward, bf16.  Against its plain version on the same
# (qkv, o, lse, do): both compute in fp32 and round dqkv to bf16 once,
# so an element may differ by one bf16 ulp of the reference (at most
# 2^-7 of |ref|) plus the fp32 reassociation of sums of O(1) terms.
# Against autograd of the plain forward (delta from the unrounded o,
# the kernel's from o in bf16): relative Frobenius error of dq, dk and
# dv each, where bf16 rounding alone gives ~1e-3.
DQKV_ULP_RTOL = 2.0 ** -7
DQKV_ATOL = 1e-5
DQKV_FROB_RTOL = 5e-3
# Adam sweep: the same fp32 expression (contraction may differ by an
# ulp of the O(1) operands); the bf16 copy within one bf16 ulp
ADAM_TOL = 1e-6
# train: the plain versions round bf16 activations at other places over
# 24 layers.  Sound kernels put the first 3 mean losses 9.35e-5,
# 5.72e-6 and 8.58e-5 from the plain run's, the same in every run (no
# kernel uses atomics); a dQ pass that skips 32 keys of each diagonal
# tile moves losses 2-3 by 3.35e-4 and 4.44e-4 (PERF.md, Findings)
TRAIN_LOSS_TOL = 2e-4
TRAIN_STEPS = 8
PLAIN_STEPS = 3
# fp16 builds: the bf16 checks' tolerances scaled to fp16's ulp (10
# mantissa bits to bf16's 7: 2^-3)
FP16_ULP_SCALE = 2.0 ** -3
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

# the serve: 8 seeded prompt lengths in [64, 700], the last pinned to
# 700 so one prompt pads past 512 tokens (the gridded prefill case)
SERVE_LENGTHS = [int(x) for x in
                 np.random.RandomState(1234).randint(64, 701, 7)] + [700]
SERVE_NEW = 32

# --- the card (NVIDIA H100 SXM data sheet, dense) ----------------------
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP16_FLOPS = 989e12
FP32_FLOPS = 67e12

REPLACES = {
    "layer_norm": "apex_tpu/ops/layer_norm.py:62",
    "flash_attention": "apex_tpu/ops/flash_attention.py:556",
    "flash_decode": "apex_tpu/ops/flash_decode.py:198",
    "layer_norm_bwd": "apex_tpu/ops/layer_norm.py:127",
    "flash_attention_e": "apex_tpu/ops/flash_attention.py:1927",
    "flash_attention_e_bwd": "apex_tpu/ops/flash_attention.py:2211",
    "fused_adam_pipeline": "apex_tpu/ops/fused_optim.py:109",
    "scaled_softmax_causal_fwd": "apex_tpu/ops/scaled_softmax.py:88",
    "scaled_softmax_bwd": "apex_tpu/ops/scaled_softmax.py:115",
    "norm_finite": "apex_tpu/ops/fused_pipeline.py:252",
}
SOURCES = {
    "layer_norm": "apex_tpu_torch/csrc/layer_norm.cu",
    "flash_attention": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_decode": "apex_tpu_torch/csrc/flash_decode.cu",
    "layer_norm_bwd": "apex_tpu_torch/csrc/layer_norm.cu",
    "flash_attention_e": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_e_bwd": "apex_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_adam_pipeline": "apex_tpu_torch/csrc/fused_adam.cu",
    "scaled_softmax_causal_fwd": "apex_tpu_torch/csrc/scaled_softmax.cu",
    "scaled_softmax_bwd": "apex_tpu_torch/csrc/scaled_softmax.cu",
    "norm_finite": "apex_tpu_torch/csrc/norm_finite.cu",
}
# the path each kernel's launches are counted on
SERVE_KERNELS = ("layer_norm", "flash_attention", "flash_decode")
TRAIN_KERNELS = ("layer_norm", "layer_norm_bwd", "flash_attention_e",
                 "flash_attention_e_bwd", "fused_adam_pipeline")
TRAIN_O2_KERNELS = ("layer_norm", "layer_norm_bwd",
                    "scaled_softmax_causal_fwd", "scaled_softmax_bwd",
                    "norm_finite", "fused_adam_pipeline")


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

    t0 = time.perf_counter()
    built = _build.build()
    dt = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.library(name)
    log(f"build: {len(built)} librar{'y' if len(built) == 1 else 'ies'} "
        f"compiled in {dt:.1f} s ({', '.join(built) or 'cached'})")
    for name, text in _build.LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# --- phase 2 ------------------------------------------------------------

def check_layer_norm(dev, g):
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
        ok = err <= LN_TOL and stat_err <= 1e-4
        log(f"kernel layer_norm rows={rows} hidden={hd} bf16 x, fp32 "
            f"gamma: max_abs_err={err:.3e} (tol {LN_TOL}) "
            f"max_rel_err={rel_err(y, yr):.3e} "
            f"stats_err={stat_err:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
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
        err, lerr = max_err(o, o_r), max_err(lse, lse_r)
        ok = err <= ATTN_TOL and lerr <= LSE_TOL
        log(f"kernel flash_attention b={b} h={h} s={s} d={d} causal "
            f"bf16: max_abs_err={err:.3e} (tol {ATTN_TOL}) "
            f"max_rel_err={rel_err(o, o_r):.3e} "
            f"lse_err={lerr:.3e} (tol {LSE_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees at "
                                 f"s={s}")
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


def check_flash_decode(dev, g):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import flash_decode, paged_attention_reference

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
    out = flash_decode(q, kc, vc, bt, sl)
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, kc, vc, bt, sl)
    err = max_err(out, ref)
    zero = bool((out[0] == 0).all())
    ok = err <= DECODE_TOL and zero
    log(f"kernel flash_decode b={b} h={h} d={d} bs={bs} pages={mp} bf16 "
        f"seq_lens={lens}: max_abs_err={err:.3e} (tol {DECODE_TOL}) "
        f"max_rel_err={rel_err(out, ref):.3e} "
        f"seq_len-0 row exactly 0: {zero} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_decode kernel disagrees")
    ms, ms_w = time_ms(lambda: flash_decode(q, kc, vc, bt, sl), iters=100)
    plain, plain_w = time_ms(
        lambda: paged_attention_reference(q, kc, vc, bt, sl))
    # library yardstick: SDPA over the pages gathered beforehand (the
    # gather itself is not timed)
    kg = kc[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    vg = vc[bt.long()].permute(0, 2, 1, 3, 4).reshape(b, h, mp * bs, d)
    mask = (torch.arange(mp * bs, device=dev)[None, :]
            < sl[:, None].clamp(min=1))[:, None, None, :]
    lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kg, vg, attn_mask=mask), iters=100)
    keys = sum(lens)
    nbytes = keys * h * d * 2 * 2 + 2 * b * h * d * 2 \
        + sum(-(-n // bs) for n in lens) * 4 + b * 4
    flops = 4.0 * keys * h * d
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    log(f"  time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), SDPA on "
        f"gathered pages {lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} "
        f"({b_by})")
    return dict(name="flash_decode",
                shape=f"b={b} h={h} d={d} bs={bs} pages={mp} bf16",
                max_abs_err=err, ms=ms, ms_wall=ms_w, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


# --- phase 2, the train step's shapes ----------------------------------

def check_layer_norm_bwd(dev, g, dtype=torch.bfloat16):
    """LayerNorm forward and backward at the train step's shape with
    gamma/beta in x's dtype: bf16 (O5) or fp16 (O2), the tolerances
    scaled to the dtype's ulp.  Returns ``(forward, backward)``
    entries."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm_backward, layer_norm_with_stats
    from apex_tpu_torch.ops.layer_norm import (layer_norm_backward_reference,
                                               layer_norm_stats_reference)

    rows, hd = 8192, 1024              # batch 8 x seq 1024, hidden 1024
    ts = 1.0 if dtype == torch.bfloat16 else FP16_ULP_SCALE
    tag = {torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    ln_tol, bwd_tol, wg_rtol = LN_TOL * ts, LN_BWD_TOL * ts, \
        LN_WGRAD_RTOL * ts
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
    ok = err <= ln_tol and stat_err <= 1e-4
    log(f"kernel layer_norm rows={rows} hidden={hd} {tag} x, {tag} "
        f"gamma/beta: max_abs_err={err:.3e} (tol {ln_tol}) "
        f"max_rel_err={rel_err(y, yr):.3e} "
        f"stats_err={stat_err:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
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
    ok = err <= bwd_tol and wrel <= wg_rtol and \
        dg.dtype == db.dtype == dtype
    log(f"kernel layer_norm_bwd rows={rows} hidden={hd} {tag} "
        f"x/dy/gamma: dx max_abs_err={err:.3e} (tol {bwd_tol}) "
        f"max_rel_err={rel_err(dx, rx):.3e}; dgamma/dbeta max_rel_err="
        f"{wrel:.3e} (tol {wg_rtol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("layer_norm_bwd kernel disagrees")
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
    """The E forward and backward at the train step's shape; returns the
    two kernel entries."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import (flash_attention_e_backward,
                                    flash_attention_e_reference,
                                    flash_attention_e_with_lse,
                                    mha_reference)
    from apex_tpu_torch.ops.flash_attention import \
        flash_attention_e_backward_reference

    b, s, h, d = 8, 1024, 16, 64
    qkv = torch.randn(b, s, h, 3 * d, generator=g, device=dev).bfloat16()
    do = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    o, lse = flash_attention_e_with_lse(qkv, causal=True)
    torch.cuda.synchronize()
    o_r, lse_r = mha_reference(q, k, v, causal=True, return_lse=True)
    o_r = o_r.transpose(1, 2).reshape(b, s, h * d)
    err, lerr = max_err(o, o_r), max_err(lse, lse_r)
    ok = err <= ATTN_TOL and lerr <= LSE_TOL
    log(f"kernel flash_attention_e b={b} s={s} h={h} d={d} causal bf16: "
        f"max_abs_err={err:.3e} (tol {ATTN_TOL}) max_rel_err="
        f"{rel_err(o, o_r):.3e} lse_err={lerr:.3e} (tol {LSE_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_e kernel disagrees")
    o4 = o.view(b, s, h, d)
    dqkv = flash_attention_e_backward(qkv, o4, lse, do, causal=True)
    torch.cuda.synchronize()
    if dqkv.shape != qkv.shape:
        raise AssertionError(f"dqkv {tuple(dqkv.shape)} != qkv's shape")
    # against the backward's plain version on the same (qkv, o, lse, do),
    # element by element and part by part
    dqkv_p = flash_attention_e_backward_reference(qkv, o4, lse, do,
                                                  causal=True)
    berr = max_err(dqkv, dqkv_p)
    parts = []
    for i, part in enumerate("qkv"):
        kp, rp = (t[..., i * d:(i + 1) * d].float() for t in (dqkv, dqkv_p))
        diff = (kp - rp).abs()
        excess = float((diff - DQKV_ULP_RTOL * rp.abs()).max())
        parts.append((part, excess, int((diff > 0).sum()),
                      float(rp.abs().median())))
    ok = all(x <= DQKV_ATOL for _, x, _, _ in parts)
    log(f"kernel flash_attention_e_bwd (dqkv in qkv's lanes) vs the "
        f"backward's plain version: max_abs_err={berr:.3e}; per part, "
        f"max(|err| - {DQKV_ULP_RTOL:.4g}|ref|) (tol {DQKV_ATOL}), "
        f"elements that differ, median |ref|: "
        + ", ".join(f"d{n} {x:.3e} {c} {m:.3e}" for n, x, c, m in parts)
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_e_bwd kernel disagrees with "
                             "its plain version")
    del dqkv_p
    # against autograd of the forward's plain version (fp32 throughout,
    # delta from the unrounded o): relative Frobenius error per part
    qr = qkv.clone().requires_grad_(True)
    out_r = flash_attention_e_reference(qr, causal=True)
    do_flat = do.reshape(b, s, h * d)
    dqkv_r, = torch.autograd.grad(out_r, qr, do_flat, retain_graph=True)
    frob = []
    for i, part in enumerate("qkv"):
        kp, rp = (t[..., i * d:(i + 1) * d].float() for t in (dqkv, dqkv_r))
        frob.append((part, float((kp - rp).norm() / rp.norm())))
    ok = all(x <= DQKV_FROB_RTOL for _, x in frob)
    log(f"kernel flash_attention_e_bwd vs autograd of mha_reference: "
        f"||err|| / ||ref|| per part "
        + ", ".join(f"d{n} {x:.3e}" for n, x in frob)
        + f" (tol {DQKV_FROB_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_e_bwd kernel disagrees with "
                             "autograd of the plain forward")
    pairs = b * h * s * (s + 1) / 2
    # forward
    ms, ms_w = time_ms(lambda: flash_attention_e_with_lse(qkv, causal=True))
    plain, plain_w = time_ms(
        lambda: mha_reference(q, k, v, causal=True, return_lse=True),
        iters=10)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    lib, lib_w = time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True))
    nbytes = b * s * h * 3 * d * 2 + b * s * h * d * 2 + b * h * s * 4
    b_ms, b_by = bound_ms(nbytes, 4.0 * d * pairs, BF16_FLOPS)
    log(f"  forward time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), SDPA "
        f"{lib:.5f} ({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
    fwd = dict(name="flash_attention_e",
               shape=f"b={b} s={s} h={h} d={d} causal bf16",
               max_abs_err=max(err, lerr), ms=ms, ms_wall=ms_w,
               plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    # backward: the plain version, autograd's and SDPA's backward alone
    # (these two through a graph kept from one forward)
    ms, ms_w = time_ms(lambda: flash_attention_e_backward(
        qkv, o4, lse, do, causal=True))
    plain, plain_w = time_ms(lambda: flash_attention_e_backward_reference(
        qkv, o4, lse, do, causal=True), iters=10)
    ag, ag_w = time_ms(lambda: torch.autograd.grad(
        out_r, qr, do_flat, retain_graph=True), iters=10)
    del out_r, dqkv_r
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (qc, kc, vc))
    out_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    do_s = do.transpose(1, 2).contiguous()
    lib, lib_w = time_ms(lambda: torch.autograd.grad(
        out_s, (qs, ks, vs), do_s, retain_graph=True))
    nbytes = 2 * b * s * h * 3 * d * 2 + 2 * b * s * h * d * 2 \
        + b * h * s * 4
    b_ms, b_by = bound_ms(nbytes, 10.0 * d * pairs, BF16_FLOPS)
    log(f"  backward time, device ms (wall ms per call): kernel {ms:.5f} "
        f"({ms_w:.5f}), plain {plain:.5f} ({plain_w:.5f}), autograd of "
        f"mha_reference {ag:.5f} ({ag_w:.5f}), SDPA backward {lib:.5f} "
        f"({lib_w:.5f}), bound {b_ms:.5f} ({b_by})")
    bwd = dict(name="flash_attention_e_bwd",
               shape=f"b={b} s={s} h={h} d={d} causal bf16",
               max_abs_err=berr, ms=ms, ms_wall=ms_w, plain_ms=plain,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib)
    return fwd, bwd


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
    lengths (each register width and the looped variant); returns the
    two kernel entries."""
    from apex_tpu_torch.ops import (causal_softmax, causal_softmax_reference,
                                    softmax_backward,
                                    softmax_backward_reference)

    scale = 0.125                      # head_dim 64 ** -0.5
    # other row lengths first: sk <= 128, 300 (two 256-row JAX blocks),
    # and 1500 (the looped variant), fp32 and bf16
    for shape in ((4, 64, 64), (3, 300, 300), (2, 1500, 1500)):
        for dtype, tol in ((torch.float32, SOFTMAX_TOL),
                           (torch.bfloat16, 2.0 ** -8)):
            x = (3 * torch.randn(*shape, generator=g, device=dev)).to(dtype)
            dy = torch.randn(*shape, generator=g, device=dev).to(dtype)
            y = causal_softmax(x, scale)
            dx = softmax_backward(y, dy, scale)
            torch.cuda.synchronize()
            err = max_err(y, causal_softmax_reference(x, scale))
            berr = rel_err(dx, softmax_backward_reference(y, dy, scale))
            zero = bool((y.triu(1) == 0).all())
            ok = err <= tol and berr <= max(tol, SOFTMAX_BWD_RTOL) and zero
            log(f"kernel scaled_softmax {tuple(shape)} {dtype}: forward "
                f"max_abs_err={err:.3e}, backward max_rel_err={berr:.3e} "
                f"(tol {tol:.3g}), upper triangle exactly 0: {zero} "
                f"{'ok' if ok else 'FAIL'}")
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
        ok = err <= tol and zero and brel <= btol
        log(f"kernel scaled_softmax_causal_fwd ({b3}, {s}, {s}) {tag}, "
            f"scale {scale}: max_abs_err={err:.3e} (tol {tol:.3g}), upper "
            f"triangle exactly 0: {zero}; scaled_softmax_bwd max_abs_err="
            f"{berr:.3e}, over max |dx| {brel:.3e} (tol {btol:.3g}) "
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
    from apex_tpu_torch.serving import gpt_sequence_logits
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
    # oracle: teacher-forced whole-sequence logits, plain versions
    plain_cfg = engine.model_cfg.plain()
    checked = ties = mism_ties = 0
    min_gap = math.inf
    for req in sorted(engine.done, key=lambda r: str(r.rid)):
        seq = req.prompt + req.out_tokens[:-1]
        toks = torch.tensor([seq], dtype=torch.long, device=dev)
        with torch.inference_mode():
            logits = gpt_sequence_logits(engine.weights, plain_cfg,
                                         toks)[0].float()
        rows = logits[len(req.prompt) - 1:]
        if rows.shape != (SERVE_NEW, mc.vocab_size) or \
                not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"{req.rid}: oracle logits "
                                 f"{tuple(rows.shape)} not finite / "
                                 f"not ({SERVE_NEW}, {mc.vocab_size})")
        top2 = rows.topk(2, dim=-1)
        gap = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        want = top2.indices[:, 0].tolist()
        for j, (got, w, gp) in enumerate(zip(req.out_tokens, want, gap)):
            checked += 1
            if gp <= gap_tol:
                ties += 1
                mism_ties += int(got != w)
                continue
            min_gap = min(min_gap, gp)
            if got != w:
                raise AssertionError(
                    f"{req.rid} token {j}: served {got}, oracle {w} "
                    f"with top-2 gap {gp:.4f} > {gap_tol}")
    log(f"serve {policy}: token check {checked} positions, {ties} under "
        f"the tie rule (top-2 gap <= {gap_tol}; {mism_ties} of them "
        f"differ), the other {checked - ties} equal the oracle")
    log(f"serve {policy}: tokens_per_sec={summary.tokens_per_sec} "
        f"decode_tokens_per_sec={summary.decode_tokens_per_sec} "
        f"ttft_p50_ms={summary.ttft_p50_ms} "
        f"ttft_p99_ms={summary.ttft_p99_ms} "
        f"token_p50_ms={summary.latency_p50_ms} "
        f"token_p99_ms={summary.latency_p99_ms} "
        f"itl_p50_ms={summary.itl_p50_ms} itl_p99_ms={summary.itl_p99_ms} "
        f"decode_steps={summary.decode_steps} wall_s={summary.wall_s}")
    return counts


def train_and_check(dev, policy: str = "O5"):
    """The train at GPT-345M width in ``policy``'s recipe (O5: flash,
    bf16, static scale; O2: the fused softmax, fp16, dynamic scale),
    launch counts reset just before; returns ``(counts, losses,
    steps)``."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.testing.standalone_gpt import MODELS, train_smoke

    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    r = train_smoke(TRAIN_STEPS, model="gpt345m", policy=policy, seed=0,
                    device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    geo = MODELS["gpt345m"]
    layers = geo["num_layers"]
    groups = len(r.setup.amp_opt.groups)
    gdtypes = "/".join(str(g.dtype).replace("torch.", "")
                       for g in r.setup.amp_opt.groups)
    want = {k: 0 for k in counts}
    want.update(layer_norm=(2 * layers + 1) * TRAIN_STEPS,
                layer_norm_bwd=(2 * layers + 1) * TRAIN_STEPS,
                fused_adam_pipeline=groups * TRAIN_STEPS)
    if policy == "O5":
        want.update(flash_attention_e=layers * TRAIN_STEPS,
                    flash_attention_e_bwd=layers * TRAIN_STEPS)
    else:
        want.update(scaled_softmax_causal_fwd=layers * TRAIN_STEPS,
                    scaled_softmax_bwd=layers * TRAIN_STEPS,
                    norm_finite=groups * TRAIN_STEPS)
    log(f"train {policy}: gpt345m (vocab {geo['vocab_size']}, hidden "
        f"{geo['hidden_size']}, {layers} layers, {geo['num_heads']} heads), "
        f"seq {geo['seq']} batch {geo['batch']}, {r.setup.n_params} params "
        f"in {groups} group(s) ({gdtypes}), {TRAIN_STEPS} steps (setup + "
        f"steps {wall:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB)")
    log(f"train {policy}: launch counts {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    losses = r.losses
    log(f"train {policy}: losses {[round(x, 6) for x in losses]}")
    if policy != "O5":
        for i, (loss, (fin, scale, skipped, gnorm)) in enumerate(
                zip(losses, r.steps)):
            log(f"  step {i + 1}: loss {loss:.6f} finite {fin} scale "
                f"{scale:g} skipped {skipped} grad_norm {gnorm!r}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    peak = BF16_FLOPS / 1e12
    dt = "bf16" if policy == "O5" else "fp16"
    log(f"train {policy}: step ms {[round(x, 3) for x in r.step_ms]}; "
        f"median of steps 3-{TRAIN_STEPS} {r.median_ms:.3f} ms, tokens/s "
        f"{r.tokens_per_sec:.1f}, model TFLOP/s {r.tflops_per_sec:.3f} "
        f"({r.setup.flops_per_step / 1e12:.3f} TFLOP a step, "
        f"{100 * r.tflops_per_sec / peak:.2f}% of the {peak:.0f} TFLOP/s "
        f"{dt} dense peak, so no step could take under "
        f"{r.setup.flops_per_step / BF16_FLOPS * 1e3:.2f} ms)")
    steps = r.steps
    del r
    free_memory()
    return counts, losses, steps


def train_plain_and_compare(dev, kernel_losses, policy: str = "O5",
                            kernel_steps=None):
    """The first steps again through the plain versions (no kernel may
    launch), each loss held against the kernel run's; under a dynamic
    scale the (finite, scale, skipped) sequence must equal it too."""
    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.testing.standalone_gpt import train_smoke

    tol = TRAIN_LOSS_TOL if policy == "O5" else TRAIN_O2_LOSS_TOL
    reset_launch_counts()
    t0 = time.perf_counter()
    r = train_smoke(PLAIN_STEPS, model="gpt345m", policy=policy, seed=0,
                    kernels=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    diffs = [abs(a - b) for a, b in zip(r.losses, kernel_losses)]
    seq = [x[:3] for x in r.steps]
    want_seq = [x[:3] for x in kernel_steps] if kernel_steps else seq
    log(f"train {policy} plain: {PLAIN_STEPS} steps through the plain "
        f"versions ({wall:.1f} s, median step {r.median_ms:.3f} ms): "
        f"losses {[round(x, 6) for x in r.losses]}, |kernel - plain| "
        f"{[f'{x:.2e}' for x in diffs]} (tol {tol}); (finite, scale, "
        f"skipped) {seq}; launches {sum(counts.values())}")
    del r
    free_memory()
    if any(counts.values()):
        raise AssertionError(f"the plain run launched kernels: {counts}")
    if len(diffs) != PLAIN_STEPS or max(diffs) > tol:
        raise AssertionError(f"plain losses differ: {diffs}")
    if seq != want_seq:
        raise AssertionError(f"plain skip sequence {seq} != the kernel "
                             f"run's {want_seq}")


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


def _profile_rows(prof):
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_train(dev, policy: str = "O5"):
    """One train step in ``policy``'s recipe under ``torch.profiler``
    (model built and two steps taken outside the window): device time by
    kernel, launches, and the device's idle share of the step's wall.
    For O2 also the fp32 GEMMs' share (the attention scores from fp16 q
    and k, upcast: cuBLAS kernels whose name marks fp32 operands)."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops import launch_counts, reset_launch_counts
    from apex_tpu_torch.testing.standalone_gpt import (MODELS,
                                                       make_train_setup,
                                                       train_step)

    setup = make_train_setup("gpt345m", policy=policy, seed=0, device=dev)
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
    log(f"train profile ({policy}, one step, profiler on): step wall "
        f"{wall:.3f} ms, device busy {busy:.3f} ms summed over kernels "
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
        layers = MODELS["gpt345m"]["num_layers"]
        log(f"train profile (O2): fp32 GEMM kernels {total:.3f} ms in "
            f"{sum(n for _, _, n in fp32)} launches "
            f"({total / layers:.3f} ms a layer, {100 * total / busy:.2f}% "
            f"of device time): "
            + "; ".join(f"{k[:60]} x{n}" for k, _, n in fp32[:4]))
    del setup
    free_memory()


def profile_serve(dev, model: str = "gpt345m"):
    """The O5 serve's ``engine.run()`` once more under ``torch.profiler``
    (weights and engine built outside the window): device busy share of
    the run's wall, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serving import (Request, ServingEngine,
                                        default_cache_config,
                                        init_serving_weights)
    from apex_tpu_torch.testing.standalone_gpt import (model_config,
                                                       seeded_prompts)

    cfg = model_config(model, policy="O5")
    weights = init_serving_weights(cfg, seed=0, device=dev)
    engine = ServingEngine(weights, cfg, default_cache_config(cfg),
                           device=dev)
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
    log(f"serve profile (O5, profiler on): run wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms summed over kernels ({100 * busy / wall:.2f}% "
        f"of the run wall, so {100 - 100 * busy / wall:.2f}% idle)")
    for name, ms, n in rows[:14]:
        log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{n:<6d} "
            f"{name[:90]}")


PHASES = ("kernels", "serve", "train", "train_o2", "profile")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (build "
                         f"always runs); the result lines print only when "
                         f"all run")
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
        if "kernels" in phases:
            for name, fn in (("layer_norm", check_layer_norm),
                             ("flash_attention", check_flash_attention),
                             ("flash_decode", check_flash_decode),
                             ("layer_norm_bwd", check_layer_norm_bwd),
                             ("flash_attention_e", check_flash_attention_e),
                             ("fused_adam_pipeline", check_fused_adam),
                             ("scaled_softmax", check_scaled_softmax),
                             ("norm_finite", check_norm_finite)):
                ok, out = run(f"kernel {name}", lambda: fn(dev, g))
                if ok:
                    for e in (out if isinstance(out, tuple) else (out,)):
                        if name == "layer_norm_bwd" and \
                                e["name"] == "layer_norm":
                            if "layer_norm" in entries:
                                entries["layer_norm"]["train"] = e
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
                counts["serve"] = out
            run("serve O0", lambda: serve_and_check(
                dev, policy="O0", gap_tol=TOKEN_GAP_TOL_FP32))
            free_memory()
        if "train" in phases:
            ok, out = run("train O5", lambda: train_and_check(dev))
            if ok:
                counts["train"], kernel_losses, _ = out
                run("train plain", lambda: train_plain_and_compare(
                    dev, kernel_losses[:PLAIN_STEPS]))
        if "train_o2" in phases:
            ok, out = run("train O2", lambda: train_and_check(dev, "O2"))
            if ok:
                counts["train_o2"], o2_losses, o2_steps = out
                run("train O2 plain", lambda: train_plain_and_compare(
                    dev, o2_losses[:PLAIN_STEPS], "O2",
                    o2_steps[:PLAIN_STEPS]))
            run("train O2 overflow", lambda: overflow_leg(dev))
        if "profile" in phases:
            if "serve" in phases:
                run("serve profile", lambda: profile_serve(dev))
            if "train" in phases:
                run("train profile", lambda: profile_train(dev))
            if "train_o2" in phases:
                run("train O2 profile", lambda: profile_train(dev, "O2"))
    if failed:
        log(f"chip_smoke FAILED: {failed}")
        return 1
    if phases != set(PHASES):
        log(f"chip_smoke: phases {sorted(phases)} passed; the result lines "
            f"print only when every phase runs")
        return 0
    kernels = []
    for name in REPLACES:
        e = dict(entries[name])
        by_path = {path: counts[path][name] for path, ks in
                   (("serve", SERVE_KERNELS), ("train", TRAIN_KERNELS),
                    ("train_o2", TRAIN_O2_KERNELS))
                   if name in ks}
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=e["max_abs_err"], ms=e["ms"], ms_wall=e["ms_wall"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            shape=e["shape"],
            **{k: e[k] for k in ("train", "fp16") if k in e}))
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
