"""Time build variants of one of the port's kernel libraries against each
other, in turns, on one CUDA card.

    python3 tools/kernel_variants.py qmm base= parent:_tree/parent/apex_tpu_torch/csrc=
    python3 tools/kernel_variants.py softmax base= parent:_tree/parent/apex_tpu_torch/csrc=
    python3 tools/kernel_variants.py causal parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py softmax_bwd parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py ln parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py decode_multi parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py decode parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py ln_bwd parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py moe parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py moe_wall . _tree/parent
    python3 tools/kernel_variants.py qmm --nohold base= probe=SOME_DEFINE
    python3 tools/kernel_variants.py wall
    python3 tools/kernel_variants.py profile

A variant is ``label[:csrc]=DEFINES``: the library's source from
``csrc`` (the port's own by default; another tree's ``csrc``, unpacked
under the ignored ``_tree/``, for an earlier version) built with ``nvcc``
and the port's flags plus ``-D`` of each comma-separated define (a switch
a source under study reads).  All variants build at once (one ``nvcc``
each) into ``apex_tpu_torch/csrc/_build/variants/``; each one's ptxas
lines for the kernels under study are printed.  Then, at every shape,
each variant is routed in as the port's library, held against the plain
version with ``chip_smoke.py``'s holds (``--nohold``: not, for
diagnostic builds whose results are wrong by design), and timed (device
ms a call, ``chip_smoke.time_ms``): the variants in order, then in
reverse, beside one PyTorch library call a turn.  Prints a line a variant
a turn and a ``TABLE`` JSON line, label -> shape -> [ms a turn].  Each
variant's output is also compared with the first variant's by
``torch.equal`` (``same bits`` on its line); for the softmax targets,
whose variants must keep the bits, a difference fails the run once every
turn is timed.

``qmm``: row 16, the GEMV (``quant_matmul`` at M = 8, bf16 x, the Q8
decode tick's four linears of GPT-345M width; qkv and fc1 also with fp16
x, whose codes convert in fewer instructions), against ``torch.matmul``
on the weight in x's dtype.  ``softmax``: row 5, the padding-mask softmax
at BERT-large's O2 step, (16, 16, 512, 512) fp16 and fp32 with its
extended mask, against ``torch.softmax`` on the pre-filled scores.
``causal``: row 3, the causal softmax forward at GPT-345M's O2 step,
(128, 1024, 1024) fp32 and fp16, against ``torch.softmax`` on the
pre-masked scores, each also through a view one element off 16-byte
alignment (``element path``), which takes the element path: so a
``parent:`` variant first shows that both paths keep the parent's bits.
``softmax_bwd``: row 4 at the same shapes on causal probabilities, at
BERT-large's O2 step, (16, 16, 512, 512) fp32 on padding-mask
probabilities, and at (2, 1500, 1500) fp32, the looped variant, against
``torch._softmax_backward_data``.
``ln``: row 1, the LayerNorm forward, at the O5 and O2 steps' (8192,
1024) bf16 and fp16 with gamma/beta in x's dtype, at the serve's prefill
(1024, 1024) and decode tick (8, 1024) with fp32 gamma/beta in bf16 and
fp16, and at (8192, 1024) bf16 and (1024, 1024) bf16 through views one
element off 16-byte alignment (``element path``), against
``F.layer_norm``; its variants must keep the bits (y, mean and rstd).
``decode_multi``: row 15 at the kernel phase's six timed cases (the
verify b=8 t=3, the chunk t=32 at 390 keys and the warm tail t=16 at 703,
each on a bf16 and an int8 cache) and its long verify (t=3 at 16,384
positions), held as the kernel phase holds them
(``DECODE_TOL``, ``decode_excess`` within ``DECODE_ATOL``, rows with
nothing to attend exactly 0) with each variant's readings printed, against
SDPA on the gathered pages; it calls the C entry itself, so that a
``parent:`` build with the earlier split rule
(``apex_flash_decode_multi_splits``) runs beside this tree's.
``decode``: row 14, the single-query decode with its merge, at the serve's
tick (b=8, 3,364 keys) on a bf16 and an int8 cache and at one row of
16,384 positions, each element held within one ulp plus ``DECODE_ATOL``,
against SDPA on the gathered pages.
``ln_bwd``: row 2, the LayerNorm backward, at the O5 and O2 steps' (8192,
1024) bf16 and fp16 with gamma in x's dtype and in fp32, at (2048, 2048)
bf16 and (2048, 1024) fp32 (the partials in shared memory), and at the
first two through x one element off 16-byte alignment (``element
path``), against aten's ``native_layer_norm_backward``; its variants
must keep the bits (dx, dgamma and dbeta).
``moe``: row 18 at ``chip_smoke.py``'s cases (``bench_moe_ep``, the MoE
serve's decode and prefill, the off-grain shapes and T = 32 and 33 at the
one-launch boundary), held as ``chip_smoke.py`` holds it; it calls the C
entry itself on outputs and scratch made once a case, so the times are
the launches' alone, and an earlier tree's entry (its scratch sized by
its own ``apex_moe_route_scratch_*``) runs beside this tree's; its
variants must keep the bits (every output, the gates and aux included).
``moe_wall``: no variants; the arguments are tree roots, and each tree's
own wrapper (``ops.moe_routing._fused``) is timed at those cases in a
process of its own, device and wall ms a call, grad on and under
``torch.inference_mode``, beside the host time a call of its parts
(``time.perf_counter``; the wrapper, the call below the autograd
Function, the launcher alone, one ``torch.empty`` of the buffer, one
``torch.cuda.device`` switch), three turns.
``wall``: no variants; the tree's own ``quant_matmul`` wrapper at those
four linears, device and back-to-back wall ms a call
(``chip_smoke.time_ms``), three turns: run a copy from another tree's
root to compare its wrapper.  ``profile``: no variants;
``torch.profiler`` over 200 back-to-back calls of the wrapper and of
``torch.matmul`` at those shapes, each kernel's mean device time (the
kernel alone, without the gaps between launches that the event times
include).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from apex_tpu_torch import _build  # noqa: E402

LIBS = {"qmm": "quant_matmul", "softmax": "scaled_softmax",
        "causal": "scaled_softmax", "softmax_bwd": "scaled_softmax",
        "ln": "layer_norm", "decode_multi": "flash_decode",
        "decode": "flash_decode", "ln_bwd": "layer_norm",
        "moe": "moe_routing"}
KERNELS = {"qmm": ("quant_gemv",), "softmax": ("masked_fwd_kernel",),
           "causal": ("causal_fwd",), "softmax_bwd": ("softmax_bwd",),
           "ln": ("ln_fwd",), "decode_multi": ("decode_multi",),
           "decode": ("decode_kernel", "decode_multi_combine"),
           "ln_bwd": ("ln_bwd",), "moe": ("route_kernel", "slot_kernel",
                                          "copy_kernel", "dispatch_kernel")}
# the targets whose variants must give the first variant's bits
BITWISE = ("softmax", "causal", "softmax_bwd", "ln", "ln_bwd", "moe")
# launchers of earlier trees that this tree's SIGNATURES no longer list
# (or list with other arguments)
_I, _P = ctypes.c_int, ctypes.c_void_p
EARLIER = {"flash_decode": {"apex_flash_decode_multi_splits": [_I, _I]},
           "moe_routing": {"apex_moe_route_scratch_ints": [_I] * 4,
                           "apex_moe_route_scratch_floats": [_I] * 2}}
# an earlier tree's entry whose arguments differ from this tree's, told
# apart by a function only the earlier tree exports
EARLIER_ARGS = {"moe_routing": ("apex_moe_route_scratch_ints",
                                {"apex_moe_route_dispatch":
                                 [_P] * 11 + [_I] * 7 + [_P]})}
O2_SCORES = (8 * 16, 1024, 1024)       # GPT-345M O2: batch 8 x 16 heads
SCALE = 0.125                          # head_dim 64 ** -0.5
OUT = _build.BUILD_DIR / "variants"


def parse(spec: str):
    head, _, defines = spec.partition("=")
    label, _, src = head.partition(":")
    csrc = (ROOT / src) if src else _build.CSRC
    return label, csrc, [d for d in defines.split(",") if d]


def build_all(lib: str, kernels, variants):
    """One nvcc a variant, all at once; label -> loaded CDLL."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, csrc, defines in variants:
        so = OUT / f"{lib}-{label}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               *[f"-D{d}" for d in defines], "-o", str(so),
               str(csrc / f"{lib}.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        so)
    loaded = {}
    for label, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {label} failed to build:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(
                    k in ln for k in kernels):
                name = ln.split("'")[1]
                usage = " | ".join(x.split(":", 1)[-1].strip()
                                   for x in lines[i + 1:i + 4]
                                   if "Used" in x or "spill" in x)
                print(f"ptxas {label}: {name} {usage}", flush=True)
        cdll = ctypes.CDLL(str(so))
        sigs = {**EARLIER.get(lib, {}), **_build.SIGNATURES[lib]}
        marker, args = EARLIER_ARGS.get(lib, (None, {}))
        if marker is not None and hasattr(cdll, marker):
            sigs.update(args)
        for fn, argtypes in sigs.items():
            f = getattr(cdll, fn, None)   # an earlier tree's set differs
            if f is None:
                continue
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        cdll.apex_cuda_error_string.argtypes = [ctypes.c_int]
        cdll.apex_cuda_error_string.restype = ctypes.c_char_p
        loaded[label] = cdll
    return loaded


def qmm_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    linears = {"qkv": (1024, 3072), "dense": (1024, 1024),
               "fc1": (1024, 4096), "fc2": (4096, 1024)}
    cases = {}
    for name, (k, n) in linears.items():
        x, wq, sc = cs._qmm_case(dev, g, 8, k, n, torch.bfloat16)
        cases[f"{name} M=8 K={k} N={n}"] = (x, wq, sc)
    for name in ("qkv", "fc1"):
        k, n = linears[name]
        x, wq, sc = cs._qmm_case(dev, g, 8, k, n, torch.float16)
        cases[f"{name} fp16"] = (x, wq, sc)
    return cases


def qmm_run(case, hold=True):
    from apex_tpu_torch.ops import quant_matmul
    x, wq, sc = case
    fn = lambda: quant_matmul(x, wq, sc)
    if not hold:
        return fn, None
    cs._qmm_hold(x, wq, sc, x.dtype, "variant")
    return fn, fn()


def qmm_library(case):
    from apex_tpu_torch.ops import dequantize_weight
    x, wq, sc = case
    wd = dequantize_weight(wq, sc, x.dtype)
    return lambda: torch.matmul(x, wd)


def softmax_cases(dev):
    from apex_tpu_torch.testing.standalone_bert import \
        bert_extended_attention_mask
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    (b, s), h = cs.BERT_BATCH, 16
    mask = bert_extended_attention_mask(cs.bert_mask(dev, g, dead_row=True))
    cases = {}
    for dt, tag in ((torch.float16, "fp16"), (torch.float32, "fp32")):
        x = (3 * torch.randn(b, h, s, s, generator=g, device=dev)).to(dt)
        cases[f"({b}, {h}, {s}, {s}) {tag}"] = (x, mask)
    return cases


def softmax_run(case, hold=True):
    from apex_tpu_torch.ops import masked_softmax, masked_softmax_reference
    x, mask = case
    fn = lambda: masked_softmax(x, mask, 0.125)
    if not hold:
        return fn, None
    y = fn()
    torch.cuda.synchronize()
    err = cs.max_err(y, masked_softmax_reference(x, mask, 0.125))
    tol = cs.SOFTMAX_FP16_TOL if x.dtype == torch.float16 else cs.SOFTMAX_TOL
    if not err <= tol or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"masked softmax variant: max_abs_err {err:.3e}"
                             f" (tol {tol})")
    return fn, y


def softmax_library(case):
    x, mask = case
    xm = (x.float() * 0.125).masked_fill(
        mask, torch.finfo(x.dtype).min).to(x.dtype)
    return lambda: torch.softmax(xm, -1)


def causal_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    cases = {}
    for dt, tag in ((torch.float32, "fp32"), (torch.float16, "fp16")):
        x = (3 * torch.randn(*O2_SCORES, generator=g, device=dev)).to(dt)
        cases[f"{O2_SCORES} {tag}"] = x, SCALE
        cases[f"{O2_SCORES} {tag} element path"] = cs.misaligned(x), SCALE
    # a scale whose products round (GPT-345M's 0.125 is exact): the
    # product must not be contracted into the exp's subtraction on one
    # path only
    x = cases[f"{O2_SCORES} fp32"][0]
    cases[f"{O2_SCORES} fp32 scale 0.1"] = x, 0.1
    cases[f"{O2_SCORES} fp32 scale 0.1 element path"] = cs.misaligned(x), 0.1
    return cases


def causal_run(case, hold=True):
    from apex_tpu_torch.ops import causal_softmax, causal_softmax_reference
    x, scale = case
    fn = lambda: causal_softmax(x, scale)
    if not hold:
        return fn, None
    y = fn()
    torch.cuda.synchronize()
    err = cs.max_err(y, causal_softmax_reference(x, scale))
    tol = cs.SOFTMAX_FP16_TOL if x.dtype == torch.float16 else cs.SOFTMAX_TOL
    zero = bool((y.triu(1) == 0).all())
    if not err <= tol or not zero:
        raise AssertionError(f"causal softmax variant: max_abs_err {err:.3e}"
                             f" (tol {tol}), upper triangle 0: {zero}")
    return fn, y


def causal_library(case):
    x, scale = case
    keep = torch.ones(x.shape[-2:], dtype=torch.bool, device=x.device).tril()
    xm = (x.float() * scale).masked_fill(~keep, float("-inf")).to(x.dtype)
    return lambda: torch.softmax(xm, -1)


def softmax_bwd_cases(dev):
    from apex_tpu_torch.ops import (causal_softmax_reference,
                                    masked_softmax_reference)
    from apex_tpu_torch.testing.standalone_bert import \
        bert_extended_attention_mask
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    cases = {}
    for dt, tag in ((torch.float32, "fp32"), (torch.float16, "fp16")):
        x = (3 * torch.randn(*O2_SCORES, generator=g, device=dev)).to(dt)
        y = causal_softmax_reference(x, SCALE)
        dy = torch.randn(*O2_SCORES, generator=g, device=dev).to(dt)
        del x
        cases[f"{O2_SCORES} {tag}"] = (y, dy)
    (b, s), h = cs.BERT_BATCH, 16
    mask = bert_extended_attention_mask(cs.bert_mask(dev, g, dead_row=True))
    x = 3 * torch.randn(b, h, s, s, generator=g, device=dev)
    y = masked_softmax_reference(x, mask, SCALE)
    dy = torch.randn(b, h, s, s, generator=g, device=dev)
    del x
    cases[f"({b}, {h}, {s}, {s}) fp32"] = (y, dy)
    # past 1024 columns: the looped variant
    x = 3 * torch.randn(2, 1500, 1500, generator=g, device=dev)
    y = causal_softmax_reference(x, SCALE)
    cases["(2, 1500, 1500) fp32"] = (
        y, torch.randn(2, 1500, 1500, generator=g, device=dev))
    return cases


def softmax_bwd_run(case, hold=True):
    from apex_tpu_torch.ops import softmax_backward, softmax_backward_reference
    y, dy = case
    fn = lambda: softmax_backward(y, dy, SCALE)
    if not hold:
        return fn, None
    dx = fn()
    torch.cuda.synchronize()
    rel = cs.rel_err(dx, softmax_backward_reference(y, dy, SCALE))
    tol = cs.SOFTMAX_FP16_TOL if y.dtype == torch.float16 else \
        cs.SOFTMAX_BWD_RTOL
    if not rel <= tol or not bool(torch.isfinite(dx).all()):
        raise AssertionError(f"softmax backward variant: max_rel_err "
                             f"{rel:.3e} (tol {tol})")
    return fn, dx


def softmax_bwd_library(case):
    y, dy = case
    return lambda: torch._softmax_backward_data(dy, y, -1, y.dtype)


def ln_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    hd = 1024
    cases = {}
    for rows, dt, wdt, tag in ((8192, torch.bfloat16, torch.bfloat16,
                                "bf16, bf16 gamma"),
                               (8192, torch.float16, torch.float16,
                                "fp16, fp16 gamma"),
                               (1024, torch.bfloat16, torch.float32,
                                "bf16, fp32 gamma"),
                               (1024, torch.float16, torch.float32,
                                "fp16, fp32 gamma"),
                               (8, torch.bfloat16, torch.float32,
                                "bf16, fp32 gamma")):
        x = torch.randn(rows, hd, generator=g, device=dev).to(dt)
        gamma = (1 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(wdt)
        beta = (0.1 * torch.randn(hd, generator=g, device=dev)).to(wdt)
        cases[f"({rows}, {hd}) {tag}"] = (x, gamma, beta)
    for key in ("(8192, 1024) bf16, bf16 gamma",
                "(1024, 1024) bf16, fp32 gamma"):
        x, gamma, beta = cases[key]
        cases[f"{key} element path"] = (cs.misaligned(x), gamma, beta)
    return cases


def ln_run(case, hold=True):
    from apex_tpu_torch.ops import layer_norm_with_stats
    from apex_tpu_torch.ops.layer_norm import layer_norm_stats_reference
    x, gamma, beta = case
    fn = lambda: layer_norm_with_stats(x, gamma, beta, 1e-5)
    if not hold:
        return fn, None
    out = fn()
    torch.cuda.synchronize()
    yr, mr, rr = layer_norm_stats_reference(x, gamma, beta, 1e-5)
    y, mean, rstd = out
    if x.dtype == torch.float16:
        u = cs.ulps_of_ref(y, yr)
        ok, what = u <= 1.0, f"{u:.3f} fp16 ulps (tol 1)"
    else:
        err = cs.max_err(y, yr)
        ok, what = err <= cs.LN_TOL, f"max_abs_err {err:.3e} (tol {cs.LN_TOL})"
    stat = max(cs.max_err(mean, mr), cs.max_err(rstd, rr))
    if not (ok and stat <= 1e-4):
        raise AssertionError(f"layer_norm variant: {what}, stats_err "
                             f"{stat:.3e} (tol 1e-4)")
    return fn, out


def ln_library(case):
    import torch.nn.functional as F
    x, gamma, beta = case
    g, b = gamma.to(x.dtype), beta.to(x.dtype)
    return lambda: F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)


LABEL = ""                # the variant being run
MULTI_FAILS = []          # (label, shape, readings) past a hold


def decode_multi_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    h, d, bs, mp, nb = 16, 64, 16, 64, 512
    cases = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        for b, t, lens in ((8, 3, [0, 2, 16 * 20 + 7, mp * bs, 700, 733, 64,
                                   515]),
                           (1, 32, [390]), (1, 16, [703])):
            kc, vc, bt, sl = cs._paged_case(dev, g, lens, h, d, bs, mp, nb)
            kc, vc, kw = cs._kv_int8(kc, vc) if int8 else (kc, vc, {})
            q = torch.randn(b, t, h, d, generator=g, device=dev).bfloat16()
            cases[f"b={b} t={t} {tag} seq_lens={lens}"] = (q, kc, vc, bt, sl,
                                                          kw)
        # the kernel phase's long verify (held there only), where a merge
        # that drops a split moves elements by less than DECODE_TOL
        b, t, lens = cs.MULTI_LONG
        kc, vc, bt, sl = cs._paged_case(dev, g, lens, h, d, bs, 1024,
                                        sum(-(-n // bs) for n in lens) + 1)
        kc, vc, kw = cs._kv_int8(kc, vc) if int8 else (kc, vc, {})
        q = torch.randn(b, t, h, d, generator=g, device=dev).bfloat16()
        cases[f"long b={b} t={t} {tag} seq_lens={lens}"] = (q, kc, vc, bt, sl,
                                                           kw)
    return cases


def _multi_call(q, kc, vc, bt, sl, kw):
    """Row 15 through the routed library's C entry: its split count from
    this tree's planner or an earlier tree's rule, the scratch for that
    many splits."""
    from apex_tpu_torch.ops.flash_decode import _ptr
    lib = _build._LIBS["flash_decode"]
    b, t, h, d = q.shape
    bs, mp = kc.shape[2], bt.shape[1]
    plan = getattr(lib, "apex_flash_decode_multi_plan", None)
    splits = plan(b, t, h, bs, mp) if plan is not None else \
        lib.apex_flash_decode_multi_splits(bs, mp)
    part = torch.empty(b * t * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    part_o = part.data_ptr()
    out = torch.empty_like(q)
    rc = lib.apex_flash_decode_multi(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), _ptr(kw.get("k_scale")),
        _ptr(kw.get("v_scale")), bt.data_ptr(), sl.data_ptr(), part_o,
        part_o + b * t * h * splits * d * 4, out.data_ptr(), b, t, h, d, bs,
        mp, q.stride(0), q.stride(1), q.stride(2), d ** -0.5,
        _build.dtype_code(q.dtype), _build.dtype_code(kc.dtype),
        _build.stream_ptr(q.device))
    _build.check("flash_decode", rc, "flash_decode_multi variant")
    return out


def decode_multi_run(case, hold=True):
    from apex_tpu_torch.ops import paged_attention_multi_reference
    q, kc, vc, bt, sl, kw = case
    fn = lambda: _multi_call(q, kc, vc, bt, sl, kw)
    if not hold:
        return fn, None
    out = fn()
    torch.cuda.synchronize()
    ref = paged_attention_multi_reference(q, kc, vc, bt, sl, **kw)
    t = q.shape[1]
    err, excess = cs.max_err(out, ref), cs.decode_excess(out, ref)
    qpos = sl.long()[:, None] - t + torch.arange(t, device=q.device)[None, :]
    zero = bool((out[qpos < 0] == 0).all())
    finite = bool(torch.isfinite(out).all())
    ok = err <= cs.DECODE_TOL and excess <= cs.DECODE_ATOL and zero and finite
    reading = (f"max_abs_err {err:.3e} (tol {cs.DECODE_TOL}), past one ulp "
               f"{excess:.3e} (tol {cs.DECODE_ATOL}), dead rows 0: {zero}, "
               f"finite: {finite} {'ok' if ok else 'FAIL'}")
    print(f"  {LABEL} hold {tuple(q.shape)} {reading}", flush=True)
    if not ok:
        MULTI_FAILS.append((LABEL, tuple(q.shape), reading))
    return fn, out


def decode_multi_library(case):
    q, kc, vc, bt, sl, kw = case
    return cs.multi_library(q, kc, vc, bt, sl, kw)


def decode_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    h, d, bs = 16, 64, 16
    lens = [0, 16 * 20 + 7, 1024, 1, 700, 733, 64, 515]
    kc, vc, bt, sl = cs._paged_case(dev, g, lens, h, d, bs, 64, 512)
    q = torch.randn(len(lens), h, d, generator=g, device=dev).bfloat16()
    kq, vq, kw = cs._kv_int8(kc, vc)
    cases = {"tick b=8 bf16": (q, kc, vc, bt, sl, {}),
             "tick b=8 int8": (q, kq, vq, bt, sl, kw)}
    kc, vc, bt, sl = cs._paged_case(dev, g, [16384], h, d, bs, 1024, 1025)
    q = torch.randn(1, h, d, generator=g, device=dev).bfloat16()
    cases["long b=1 bf16 16384"] = (q, kc, vc, bt, sl, {})
    return cases


def decode_run(case, hold=True):
    from apex_tpu_torch.ops import flash_decode, paged_attention_reference
    q, kc, vc, bt, sl, kw = case
    fn = lambda: flash_decode(q, kc, vc, bt, sl, **kw)
    if not hold:
        return fn, None
    out = fn()
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, kc, vc, bt, sl, **kw)
    err, excess = cs.max_err(out, ref), cs.decode_excess(out, ref)
    if not (err <= cs.DECODE_TOL and excess <= cs.DECODE_ATOL):
        raise AssertionError(f"decode variant: max_abs_err {err:.3e}, past "
                             f"one ulp {excess:.3e}")
    return fn, out


def decode_library(case):
    q, kc, vc, bt, sl, kw = case
    return cs.multi_library(q[:, None], kc, vc, bt, sl, kw)


def ln_bwd_cases(dev):
    from apex_tpu_torch.ops.layer_norm import layer_norm_stats_reference
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    cases = {}
    for rows, hd, dt, wdt, tag in (
            (8192, 1024, torch.bfloat16, torch.bfloat16, "bf16, bf16 gamma"),
            (8192, 1024, torch.float16, torch.float16, "fp16, fp16 gamma"),
            (8192, 1024, torch.bfloat16, torch.float32, "bf16, fp32 gamma"),
            (8192, 1024, torch.float16, torch.float32, "fp16, fp32 gamma"),
            (2048, 2048, torch.bfloat16, torch.bfloat16, "bf16, bf16 gamma"),
            (2048, 1024, torch.float32, torch.float32, "fp32, fp32 gamma")):
        x = torch.randn(rows, hd, generator=g, device=dev).to(dt)
        dy = torch.randn(rows, hd, generator=g, device=dev).to(dt)
        gamma = (1 + 0.1 * torch.randn(hd, generator=g, device=dev)).to(wdt)
        _, mean, rstd = layer_norm_stats_reference(x, None, None, 1e-5)
        cases[f"({rows}, {hd}) {tag}"] = (x, gamma, dy, mean, rstd)
    for key in ("(8192, 1024) bf16, bf16 gamma",
                "(8192, 1024) fp16, fp16 gamma"):
        x, gamma, dy, mean, rstd = cases[key]
        cases[f"{key} element path"] = (cs.misaligned(x), gamma, dy, mean,
                                        rstd)
    return cases


def ln_bwd_run(case, hold=True):
    from apex_tpu_torch.ops import layer_norm_backward
    from apex_tpu_torch.ops.layer_norm import layer_norm_backward_reference
    x, gamma, dy, mean, rstd = case
    fn = lambda: layer_norm_backward(x, gamma, dy, mean, rstd)
    if not hold:
        return fn, None
    out = fn()
    torch.cuda.synchronize()
    rx, rg, rb = layer_norm_backward_reference(x, gamma, dy, mean, rstd)
    dx, dg, db = out
    wrel = max(cs.rel_err(dg, rg), cs.rel_err(db, rb))
    if x.dtype == torch.float16:
        u = cs.ulps_of_ref(dx, rx)
        ok, what = u <= 1.0, f"dx {u:.3f} fp16 ulps (tol 1)"
    else:
        err = cs.max_err(dx, rx)
        tol = cs.LN_BWD_TOL if x.dtype == torch.bfloat16 else 1e-4
        ok, what = err <= tol, f"dx max_abs_err {err:.3e} (tol {tol})"
    if not (ok and wrel <= cs.LN_WGRAD_RTOL):
        raise AssertionError(f"layer_norm_bwd variant: {what}, dgamma/dbeta "
                             f"max_rel_err {wrel:.3e} (tol "
                             f"{cs.LN_WGRAD_RTOL})")
    return fn, out


def ln_bwd_library(case):
    x, gamma, dy, mean, rstd = case
    hd = x.shape[-1]
    gw = gamma.to(x.dtype)
    return lambda: torch.ops.aten.native_layer_norm_backward(
        dy, x, [hd], mean, rstd, gw, gw, [True, True, True])


def moe_cases(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    cases = {}
    for label, t, h, ne, cap, k, pol, dt in cs.MOE_CASES:
        x = torch.randn(t, h, generator=g, device=dev)
        logits = x @ (0.02 * torch.randn(h, ne, generator=g, device=dev))
        u = torch.rand(t, generator=g, device=dev) if pol == "random" \
            else None
        cases[label] = (x.to(dt), logits, u,
                        dict(capacity=cap, top_k=k, second_policy=pol))
    return cases


def _moe_args(case):
    """The routed library's entry on outputs (and scratch) made once:
    ``(call, outputs)``; the scratch by the library's own rule."""
    from apex_tpu_torch.ops.moe_routing import RouteDispatch, _scratch_words
    lib = _build._LIBS["moe_routing"]
    x, logits, u, kw = case
    t, h = x.shape
    e, cap, k = logits.shape[1], kw["capacity"], kw["top_k"]
    dev = x.device
    idx = torch.empty((k, t), dtype=torch.int32, device=dev)
    gate = torch.empty((k, t), dtype=torch.float32, device=dev)
    slot = torch.empty(k * t, dtype=torch.int32, device=dev)
    keep = torch.empty(k * t, dtype=torch.bool, device=dev)
    aux = torch.empty((), dtype=torch.float32, device=dev)
    buf = torch.empty((e, cap, h), dtype=x.dtype, device=dev)
    random = int(kw["second_policy"] == "random")
    head = (x.data_ptr(), logits.data_ptr(),
            u.data_ptr() if u is not None else None, idx.data_ptr(),
            gate.data_ptr(), slot.data_ptr(), keep.data_ptr(),
            aux.data_ptr(), buf.data_ptr())
    tail = (t, h, e, cap, k, random, x.element_size(),
            _build.stream_ptr(dev))
    if hasattr(lib, "apex_moe_route_scratch_ints"):      # an earlier tree
        si = torch.empty(lib.apex_moe_route_scratch_ints(t, e, cap, k),
                         dtype=torch.int32, device=dev)
        sf = torch.empty(lib.apex_moe_route_scratch_floats(t, e),
                         dtype=torch.float32, device=dev)
        scratch = (si.data_ptr(), sf.data_ptr())
        keepalive = (si, sf)
    else:
        words = _scratch_words(t, e, k)
        ws = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
        scratch = (ws.data_ptr() if words else None,)
        keepalive = (ws,)

    def call():
        rc = lib.apex_moe_route_dispatch(*head, *scratch, *tail)
        _build.check("moe_routing", rc, "moe_route_dispatch variant")
        return keepalive

    out = RouteDispatch(buf=buf, expert_index=idx, gate=gate, slot=slot,
                        keep=keep, load_balancing_loss=aux)
    return call, out


def moe_run(case, hold=True):
    x, logits, u, kw = case
    call, out = _moe_args(case)
    if not hold:
        return call, None
    call()
    torch.cuda.synchronize()
    cs._route_hold(f"moe variant {LABEL}", x, logits, u, kw, out)
    return call, tuple(t.clone() for t in out)


def moe_library(case):
    from apex_tpu_torch.ops import moe_route_dispatch_reference
    x, logits, u, kw = case
    # no single PyTorch call computes it: the plain version
    return lambda: moe_route_dispatch_reference(x, logits, u, **kw)


_MOE_WALL = r"""
import importlib.util, json, sys, time
import torch
root, cs_path, turns = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
spec = importlib.util.spec_from_file_location("cs", cs_path)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from apex_tpu_torch.ops import moe_routing as m
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev)
g.manual_seed(13)
cases = {}
for label, t, h, ne, cap, k, pol, dt in cs.MOE_CASES:
    x = torch.randn(t, h, generator=g, device=dev)
    logits = x @ (0.02 * torch.randn(h, ne, generator=g, device=dev))
    u = torch.rand(t, generator=g, device=dev) if pol == "random" else None
    cases[label] = (x.to(dt), logits, u,
                    dict(capacity=cap, top_k=k, second_policy=pol))


def host_us(fn, n=2000, batch=100):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / n * 1e6


for turn in range(turns):
    row = {}
    for label, (x, logits, u, kw) in cases.items():
        random = kw["second_policy"] == "random"
        fused = lambda: m._fused(x, logits, u, **kw)
        ms, wall = cs.time_ms(fused, iters=200)
        with torch.inference_mode():
            ms_i, wall_i = cs.time_ms(fused, iters=200)
        buf_shape = (logits.shape[1], kw["capacity"], x.shape[1])
        parts = {
            "wrapper": host_us(fused),
            "below the Function": host_us(lambda: m._route_dispatch(
                x, logits, u, kw["capacity"], kw["top_k"],
                kw["second_policy"])),
            "launcher": host_us(lambda: m._launch(
                x, logits, u if random else None, kw["capacity"],
                kw["top_k"], random)),
            "torch.empty of the buffer": host_us(lambda: torch.empty(
                buf_shape, dtype=x.dtype, device=dev)),
            "torch.cuda.device": host_us(
                lambda: torch.cuda.device(dev).__enter__() or None),
        }
        row[label] = dict(ms=round(ms, 5), wall=round(wall, 5),
                          ms_inference=round(ms_i, 5),
                          wall_inference=round(wall_i, 5),
                          host_us={k: round(v, 2) for k, v in parts.items()})
    print("MOE_WALL " + json.dumps(dict(root=root, turn=turn, row=row)),
          flush=True)
"""


def moe_wall(roots):
    """Each tree's own MoE wrapper at the cases, one process a tree, in
    turns: the trees in order, then in reverse."""
    for turn, order in enumerate((roots, roots[::-1])):
        for root in order:
            r = subprocess.run([sys.executable, "-c", _MOE_WALL,
                                str(ROOT / root), str(ROOT / "chip_smoke.py"),
                                "1"], capture_output=True, text=True,
                               timeout=900)
            sys.stdout.write(r.stdout)
            if r.returncode:
                sys.exit(f"moe_wall {root}: exit {r.returncode}\n"
                         f"{r.stderr[-3000:]}")
            sys.stdout.flush()


WHICH = {"qmm": (qmm_cases, qmm_run, qmm_library),
         "softmax": (softmax_cases, softmax_run, softmax_library),
         "causal": (causal_cases, causal_run, causal_library),
         "softmax_bwd": (softmax_bwd_cases, softmax_bwd_run,
                         softmax_bwd_library),
         "ln": (ln_cases, ln_run, ln_library),
         "decode_multi": (decode_multi_cases, decode_multi_run,
                          decode_multi_library),
         "decode": (decode_cases, decode_run, decode_library),
         "ln_bwd": (ln_bwd_cases, ln_bwd_run, ln_bwd_library),
         "moe": (moe_cases, moe_run, moe_library)}


def wall(dev):
    from apex_tpu_torch.ops import quant_matmul
    for turn in range(3):
        row = {}
        for shape, (x, wq, sc) in list(qmm_cases(dev).items())[:4]:
            ms, ms_w = cs.time_ms(lambda: quant_matmul(x, wq, sc), iters=100)
            row[shape] = (round(ms, 5), round(ms_w, 5))
        print(f"wall turn {turn} (device ms, wall ms) {row}", flush=True)


def profile(dev):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof
    from apex_tpu_torch.ops import dequantize_weight, quant_matmul
    for shape, (x, wq, sc) in list(qmm_cases(dev).items())[:4]:
        wd = dequantize_weight(wq, sc, x.dtype)
        for label, fn in (("quant_matmul", lambda: quant_matmul(x, wq, sc)),
                          ("torch.matmul", lambda: torch.matmul(x, wd))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                for _ in range(200):
                    fn()
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / max(e.count, 1), e.count)
                    for e in p.key_averages() if e.self_device_time_total > 0]
            for key, us, count in rows:
                print(f"profile {shape} {label}: {key[:90]} x{count} "
                      f"{us / 1e3:.5f} ms a launch", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", choices=sorted(WHICH) + ["wall", "profile",
                                                      "moe_wall"])
    ap.add_argument("variants", nargs="*", help="label[:csrc]=DEFINES")
    ap.add_argument("--nohold", action="store_true",
                    help="time without the holds (diagnostic builds whose "
                         "results are wrong by design)")
    args = ap.parse_intermixed_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    if args.which in ("wall", "profile"):
        {"wall": wall, "profile": profile}[args.which](torch.device("cuda", 0))
        sys.exit(0)
    if args.which == "moe_wall":
        moe_wall(args.variants or ["."])
        sys.exit(0)
    lib = LIBS[args.which]
    variants = [parse(v) for v in args.variants]
    loaded = build_all(lib, KERNELS[args.which], variants)
    make_cases, run, library = WHICH[args.which]
    dev = torch.device("cuda", 0)
    cases = make_cases(dev)
    labels = [v[0] for v in variants]
    table = {lb: {s: [] for s in cases} for lb in labels + ["library"]}
    first = {}                          # shape -> the first variant's output
    differs = set()
    for turn, order in enumerate((labels, labels[::-1])):
        for label in order:
            _build._LIBS[lib] = loaded[label]
            LABEL = label
            row, same = {}, {}
            for shape, case in cases.items():
                fn, out = run(case, hold=not args.nohold)
                if out is not None:
                    outs = out if isinstance(out, tuple) else (out,)
                    want = first.setdefault(shape, outs)
                    same[shape] = all(torch.equal(a, b)
                                      for a, b in zip(outs, want))
                    if not same[shape]:
                        differs.add((label, shape))
                    del out
                ms, _ = cs.time_ms(fn, iters=100)
                table[label][shape].append(ms)
                row[shape] = round(ms, 5)
            print(f"{label} turn {turn} {row}", flush=True)
            if same:
                print(f"{label} turn {turn} same bits as {labels[0]}: "
                      f"{same}", flush=True)
        row = {}
        for shape, case in cases.items():
            ms, _ = cs.time_ms(library(case), iters=100)
            table["library"][shape].append(ms)
            row[shape] = round(ms, 5)
        print(f"library turn {turn} {row}", flush=True)
    print("TABLE " + json.dumps(table), flush=True)
    if MULTI_FAILS:
        sys.exit(f"kernel_variants: holds failed: {MULTI_FAILS}")
    if differs and args.which in BITWISE:
        sys.exit(f"kernel_variants: other bits than {labels[0]}'s: "
                 f"{sorted(differs)}")
