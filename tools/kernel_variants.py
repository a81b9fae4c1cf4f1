"""Time build variants of one of the port's kernel libraries against each
other, in turns, on one CUDA card.

    python3 tools/kernel_variants.py qmm base= parent:_tree/parent/apex_tpu_torch/csrc=
    python3 tools/kernel_variants.py softmax base= parent:_tree/parent/apex_tpu_torch/csrc=
    python3 tools/kernel_variants.py causal parent:_tree/parent/apex_tpu_torch/csrc= base=
    python3 tools/kernel_variants.py softmax_bwd parent:_tree/parent/apex_tpu_torch/csrc= base=
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
        "causal": "scaled_softmax", "softmax_bwd": "scaled_softmax"}
KERNELS = {"qmm": ("quant_gemv",), "softmax": ("masked_fwd_kernel",),
           "causal": ("causal_fwd",), "softmax_bwd": ("softmax_bwd",)}
# the targets whose variants must give the first variant's bits
BITWISE = ("softmax", "causal", "softmax_bwd")
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
        for fn, argtypes in _build.SIGNATURES[lib].items():
            f = getattr(cdll, fn)
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


WHICH = {"qmm": (qmm_cases, qmm_run, qmm_library),
         "softmax": (softmax_cases, softmax_run, softmax_library),
         "causal": (causal_cases, causal_run, causal_library),
         "softmax_bwd": (softmax_bwd_cases, softmax_bwd_run,
                         softmax_bwd_library)}


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
    ap.add_argument("which", choices=sorted(WHICH) + ["wall", "profile"])
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
            row, same = {}, {}
            for shape, case in cases.items():
                fn, out = run(case, hold=not args.nohold)
                if out is not None:
                    want = first.setdefault(shape, out)
                    same[shape] = bool(torch.equal(out, want))
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
    if differs and args.which in BITWISE:
        sys.exit(f"kernel_variants: other bits than {labels[0]}'s: "
                 f"{sorted(differs)}")
