"""Chip smoke for the PyTorch/H100 port (``apex_tpu_torch``).

    python3 chip_smoke.py            # one CUDA card, from the repo root

Phases, in order; any failure exits non-zero without the result line:

1. build   — compile every kernel under ``apex_tpu_torch/csrc`` (one
             ``nvcc`` per source, all at once) and print the card's
             ``nvidia-smi`` name and power limit.
2. kernels — hold each kernel against its plain PyTorch version on the
             card at the serving path's shapes, with the stated
             tolerances, and time kernel, plain version, one library
             call and the card's bound.
3. serve   — GPT-345M width (vocab 50304, hidden 1024, 24 layers, 16
             heads, max_seq 1024), O5 bf16, seeded random weights:
             serve 8 seeded prompts of 64..700 tokens for 32 new tokens
             each through ``standalone_gpt.serve_smoke`` with every
             launch count reset just before; every kernel must have
             launched, and every served token must equal the argmax of
             ``gpt_sequence_logits`` run teacher-forced through the plain
             versions wherever that oracle's top-2 logit gap exceeds
             ``TOKEN_GAP_TOL``.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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

# the serve: 8 seeded prompt lengths in [64, 700], the last pinned to
# 700 so one prompt pads past 512 tokens (the gridded prefill case)
SERVE_LENGTHS = [int(x) for x in
                 np.random.RandomState(1234).randint(64, 701, 7)] + [700]
SERVE_NEW = 32

# --- the card (NVIDIA H100 SXM data sheet, dense) ----------------------
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

REPLACES = {
    "layer_norm": "apex_tpu/ops/layer_norm.py:62",
    "flash_attention": "apex_tpu/ops/flash_attention.py:556",
    "flash_decode": "apex_tpu/ops/flash_decode.py:198",
}
SOURCES = {
    "layer_norm": "apex_tpu_torch/csrc/layer_norm.cu",
    "flash_attention": "apex_tpu_torch/csrc/flash_attention.cu",
    "flash_decode": "apex_tpu_torch/csrc/flash_decode.cu",
}


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
        if any(counts[k] <= 0 for k in counts):
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
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"serve profile (O5, profiler on): run wall {wall:.3f} ms, device "
        f"busy {busy:.3f} ms summed over kernels ({100 * busy / wall:.2f}% "
        f"of the run wall, so {100 - 100 * busy / wall:.2f}% idle)")
    for name, ms, n in rows[:14]:
        log(f"  {ms:10.3f} ms {100 * ms / busy:6.2f}%  x{n:<6d} "
            f"{name[:90]}")


def main() -> int:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    failed = []
    entries = {}
    counts = {}
    try:
        smi = nvidia_smi()
    except Exception as e:  # the line is part of the contract
        smi = None
        failed.append(f"nvidia-smi: {e}")
    try:
        phase_build()
    except Exception:
        traceback.print_exc()
        failed.append("build")
    if not failed:
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        for name, fn in (("layer_norm", check_layer_norm),
                         ("flash_attention", check_flash_attention),
                         ("flash_decode", check_flash_decode)):
            try:
                entries[name] = fn(dev, g)
            except Exception:
                traceback.print_exc()
                failed.append(f"kernel {name}")
        for what, fn in (
                ("serve O5", lambda: serve_and_check(
                    dev, policy="O5", gap_tol=TOKEN_GAP_TOL, counted=True)),
                ("serve O0", lambda: serve_and_check(
                    dev, policy="O0", gap_tol=TOKEN_GAP_TOL_FP32)),
                ("serve profile", lambda: profile_serve(dev))):
            try:
                out = fn()
            except Exception:
                traceback.print_exc()
                failed.append(what)
                continue
            if what == "serve O5":
                counts = out
    if failed:
        log(f"chip_smoke FAILED: {failed}")
        return 1
    kernels = []
    for name in ("layer_norm", "flash_attention", "flash_decode"):
        e = dict(entries[name])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=e["max_abs_err"], ms=e["ms"],
            ms_wall=e["ms_wall"],
            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"],
            shape=e["shape"]))
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(k[key]):
                log(f"chip_smoke FAILED: {k['name']} {key} = {k[key]}")
                return 1
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
