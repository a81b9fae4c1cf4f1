"""Build the CUDA kernels under ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and compiles on its
own into ``csrc/_build/<name>-<hash>.so`` with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <lib> <source>

The hash covers the source and the flags, so an edited source never
loads a stale library.  :func:`build` starts one ``nvcc`` per missing
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
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("layer_norm", "flash_attention", "flash_decode",
           "flash_attention_bwd", "fused_adam")
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
        # q, k, v, o, lse, b, h, sq, sk, d,
        # q/k/v/o strides (b, h, s) in elements, scale, causal, dtype,
        # stream
        "apex_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I] + [_L] * 12 + [_F, _I, _I, _P],
    },
    "flash_decode": {
        # q, k_cache, v_cache, block_tables, seq_lens, out,
        # b, h, d, block_size, max_pages, q stride b, q stride h,
        # scale, dtype, stream
        "apex_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _L, _L, _F, _I, _P],
    },
    "flash_attention_bwd": {
        # q, k, v, o, do, lse, dq, dk, dv, delta, lse2, b, h, s, d,
        # q/k/v/o/do/dq/dk/dv strides (b, h, s) in elements, scale,
        # causal, dtype, stream
        "apex_flash_attention_bwd": [_P] * 11 + [_I] * 4 + [_L] * 24
        + [_F, _I, _I, _P],
    },
    "fused_adam": {
        # g, p, m, v, lowp, n, lr, beta1, beta2, eps, weight_decay, bc1,
        # bc2, gscale, keep, adam_w_mode, g_dtype, lowp_dtype, stream
        "apex_adam_pipeline": [_P] * 5 + [_L] + [_F] * 9 + [_I] * 3 + [_P],
    },
}

# dtype codes shared by every launcher
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}

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


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
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
    import torch

    return torch.cuda.current_stream(device).cuda_stream
