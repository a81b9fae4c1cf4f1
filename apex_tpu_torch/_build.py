"""Build the CUDA kernels under ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles on its
own into ``csrc/_build/<name>-<hash>.so`` with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <lib> <source>

The hash covers the source, the shared headers it includes
(``csrc/*.cuh``, and the headers those include) and the flags, so an
edited source never loads a stale library.  :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them together; :func:`library`
builds on first use and sets every exported function's ``argtypes``
(``c_void_p`` for pointers and the stream, so no pointer is cut to 32
bits).  Every launcher returns a ``cudaError_t``; :func:`check` raises
on anything but 0.  Nothing here runs at import: the CPU tests import
every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("layer_norm", "flash_attention", "flash_decode",
           "flash_attention_bwd", "fused_adam", "scaled_softmax",
           "norm_finite", "quant_matmul", "fused_lamb", "moe_routing",
           "fused_sgd", "fused_optim_update", "flash_attention_partial")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# exported launcher -> argtypes; every launcher returns an int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "layer_norm": {
        # x, gamma, beta, y, mean, rstd, rows, hidden, eps,
        # x_dtype, w_dtype, stream
        "apex_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F,
                                _I, _I, _P],
        # x, gamma, dy, mean, rstd, dx, dgamma_part, dbeta_part, dgamma,
        # dbeta, rows, hidden, parts, x_dtype, w_dtype, stream
        "apex_layer_norm_bwd": [_P] * 10 + [_I] * 5 + [_P],
    },
    "flash_attention": {
        # q, k, v, o, lse, kv_mask (null: none), b, h, sq, sk, d,
        # q/k/v/o strides (b, h, s) in elements, scale, causal, dropout
        # seed, hash width, threshold (0: no dropout) and 1 / (1 - rate),
        # dtype, stream
        "apex_flash_attention_fwd": [_P] * 6 + [_I] * 5 + [_L] * 12
        + [_F, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_decode": {
        # b, h, block_size, max_pages -> the number of position splits
        "apex_flash_decode_splits": [_I] * 4,
        # q, k_cache, v_cache, k_scale, v_scale (null for a float
        # cache), block_tables, seq_lens, part_o, part_ml (fp32 scratch,
        # null at one split), out, b, h, d, block_size, max_pages, q
        # stride b, q stride h, scale, q dtype, cache dtype, stream
        "apex_flash_decode": [_P] * 10 + [_I] * 5 + [_L, _L, _F, _I, _I,
                                                     _P],
        # b, t, h, block_size, max_pages -> the number of position splits
        "apex_flash_decode_multi_plan": [_I] * 5,
        # q (b, t, h, d), k_cache, v_cache, k_scale, v_scale,
        # block_tables, seq_lens, part_o, part_ml (fp32 scratch, null at
        # one split), out, b,
        # t, h, d, block_size, max_pages, q strides b, t, h, scale,
        # q dtype, cache dtype, stream
        "apex_flash_decode_multi": [_P] * 10 + [_I] * 6 + [_L] * 3
        + [_F, _I, _I, _P],
    },
    "flash_attention_bwd": {
        # q, k, v, o, do, lse, dq, dk, dv, delta, lse2, kv_mask (null:
        # none), b, h, sq, sk, d, q/k/v/o/do/dq/dk/dv strides (b, h, s)
        # in elements, scale, causal, the forward's dropout arguments,
        # dtype, stream
        "apex_flash_attention_bwd": [_P] * 12 + [_I] * 5 + [_L] * 24
        + [_F, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_attention_partial": {
        # q, k, v, o, lse, b, h, sq, sk, d, q/k/v/o strides (b, h, s) in
        # elements, scale, causal, diag (q_off - k_off), a dead row's lse,
        # dropout seed, threshold (0: none), 1 / (1 - rate), the
        # coordinate hash's q0, k0 and h0, dtype, stream
        "apex_flash_partial_fwd": [_P] * 5 + [_I] * 5 + [_L] * 12
        + [_F, _I, _I, _F, _I, _I, _F, _I, _I, _I, _I, _P],
        # q, k, v, o, do, lse, dlse (null: none), dq, dk, dv, delta,
        # lse2, b, h, sq, sk, d, q/k/v/o/do/dq/dk/dv strides, scale,
        # causal, diag, the forward's dropout arguments, dtype, stream
        "apex_flash_partial_bwd": [_P] * 12 + [_I] * 5 + [_L] * 24
        + [_F, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    },
    "fused_adam": {
        # g, p, m, v, lowp, n, lr, beta1, beta2, eps, weight_decay, bc1,
        # bc2, gscale, keep, adam_w_mode, g_dtype, lowp_dtype, stream
        "apex_adam_pipeline": [_P] * 5 + [_L] + [_F] * 9 + [_I] * 3 + [_P],
        # -> the leaves one apex_adam_step_leaves launch takes
        "apex_adam_step_capacity": [],
        # ptrs ((count, 5) int64: g, p, m, v, lowp), ns ((count,) int64),
        # count, chunk, lr, beta1, 1 - beta1, beta2, 1 - beta2, eps,
        # weight_decay, bc1, bc2, adam_w_mode, g_dtype, lowp_dtype,
        # p_dtype, stream
        "apex_adam_step_leaves": [_P, _P, _I, _I] + [_F] * 9 + [_I] * 4
        + [_P],
    },
    "fused_sgd": {
        # -> the leaves one apex_sgd_step_leaves launch takes
        "apex_sgd_step_capacity": [],
        # ptrs ((count, 4) int64: g, p, mom, lowp), ns ((count,) int64),
        # count, chunk, lr, momentum, 1 - dampening, weight_decay,
        # first_run, nesterov, wd_after_momentum, g_dtype, lowp_dtype,
        # stream
        "apex_sgd_step_leaves": [_P, _P, _I, _I] + [_F] * 4 + [_I] * 5
        + [_P],
        # g, p, mom, lowp, gscale, keep (device fp32 scalars), n, lr,
        # momentum, 1 - dampening, weight_decay, first_run, nesterov,
        # wd_after_momentum, g_dtype, lowp_dtype, stream
        "apex_sgd_pipeline": [_P] * 6 + [_L] + [_F] * 4 + [_I] * 5 + [_P],
    },
    "fused_optim_update": {
        # g, p, m, v, delta, m_out, v_out, n, lr, beta1, 1 - beta1, beta2,
        # 1 - beta2, eps, weight_decay, bc1, bc2, adam_w_mode, g_dtype,
        # p_dtype, stream
        "apex_adam_update": [_P] * 7 + [_L] + [_F] * 9 + [_I] * 3 + [_P],
        # g, p, h, delta, h_out, n, lr, eps, weight_decay, g_dtype,
        # p_dtype, stream
        "apex_adagrad_update": [_P] * 5 + [_L] + [_F] * 3 + [_I] * 2 + [_P],
        # g, p, m, denom, delta, m_out, n, lr, beta1, beta3, weight_decay,
        # bc1, g_dtype, p_dtype, stream
        "apex_novograd_update": [_P] * 6 + [_L] + [_F] * 5 + [_I] * 2
        + [_P],
        # g, p, mom, delta, mom_out, n, lr, momentum, 1 - dampening,
        # weight_decay, first_run, nesterov, wd_after_momentum, g_dtype,
        # p_dtype, stream
        "apex_sgd_update": [_P] * 5 + [_L] + [_F] * 4 + [_I] * 5 + [_P],
    },
    "fused_lamb": {
        # g, p, m, v, u, gscale (device fp32 scalar), n, beta1, beta2,
        # beta3, eps, weight_decay, bc1, bc2, adam_w_mode, g_dtype,
        # stream
        "apex_lamb_phase1": [_P] * 6 + [_L] + [_F] * 7 + [_I] * 2 + [_P],
    },
    "scaled_softmax": {
        # x, y, rows, sq, sk, scale, dtype, stream
        "apex_causal_softmax_fwd": [_P, _P, _L, _I, _I, _F, _I, _P],
        # y, dy, dx, rows, sk, scale, dtype, stream
        "apex_softmax_bwd": [_P, _P, _P, _L, _I, _F, _I, _P],
        # x, mask (uint8, (b, 1, sq, sk) with batch stride mask_sb), y,
        # b, np, sq, sk, mask_sb, scale, dtype, stream
        "apex_masked_softmax_fwd": [_P, _P, _P, _I, _I, _I, _I, _L, _F,
                                    _I, _P],
    },
    "norm_finite": {
        # n -> the number of partial slots (blocks) the sweep uses
        "apex_norm_finite_blocks": [_L],
        # g, n, inv, part, fin_part, blocks, out, dtype, stream
        "apex_norm_finite": [_P, _L, _F, _P, _P, _I, _P, _I, _P],
    },
    "quant_matmul": {
        # x, wq, scale, out, m, n, k, x dtype, out dtype, stream
        "apex_quant_gemv": [_P] * 4 + [_I] * 5 + [_P],
        "apex_quant_tiled": [_P] * 4 + [_I] * 5 + [_P],
    },
    "moe_routing": {
        # x, logits, u (null unless random), idx, gate, slot, keep, aux,
        # buf, int32 scratch (null at T <= 32), T, H, E, capacity, top_k,
        # random, x element bytes, stream
        "apex_moe_route_dispatch": [_P] * 10 + [_I] * 7 + [_P],
    },
}

# dtype codes shared by every launcher (int8: the paged kernels' cache)
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2, "int8": 3}

LOGS: Dict[str, str] = {}          # name -> nvcc's stderr (ptxas -v)
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"dtype {dtype} is not one the kernels take "
                        f"({sorted(DTYPE_CODES)})")
    return DTYPE_CODES[name]


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc") if os.environ.get("CUDA_HOME")
                 else None,
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put "
                       "the CUDA toolkit under /usr/local/cuda")


def _sources(name: str) -> bytes:
    """The bytes of ``csrc/<name>`` and of every ``csrc`` header it
    includes, directly or through another header."""
    seen, todo, out = set(), [name], b""
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        text = (CSRC / f).read_bytes()
        out += text
        todo += [h.decode() for h in re.findall(rb'#include "(\w+\.cuh)"',
                                                 text)]
    return out


def lib_path(name: str) -> Path:
    src = _sources(f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every named library that is not built yet: one ``nvcc``
    per source, all started together.  Returns the names it built;
    raises with the compiler's output if any build fails."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        LOGS[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
            lib.apex_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(name: str, rc: int, what: str) -> None:
    """Raise if a launcher reported an error (refused launch, bad
    argument, a fault left by an earlier kernel)."""
    if rc != 0:
        msg = library(name).apex_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """The handle of the current stream on ``device``, a CUDA tensor's
    (indexed) device: PyTorch's raw getter, with no ``Stream`` object
    built a launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
