"""Build the port's CUDA sources with g++ over this directory's stand-in
of the CUDA runtime, and route the port's launches to them.

The sources are rewritten for the host compiler (:func:`host_source`),
compiled one library a process, all at once (:func:`build`), and bound
with the port's own ctypes signatures; :func:`route` makes the port's
wrappers launch them on CPU tensors.  The ``tests/test_torch_*_emulated.py``
files share this.
"""
import contextlib
import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from apex_tpu_torch import _build

EMU = Path(__file__).resolve().parent
# the definitions `warp_prims.h` replaces
PRIMS = ("smem_addr", "ldsm_x4", "ldsm_x4_t", "cp_async16", "cp_async4",
         "cp_async_commit", "cp_async_wait", "mma16816",
         "cluster_arrive_relaxed", "cluster_arrive", "cluster_wait")


def host_source(text: str) -> str:
    """A CUDA source as g++ takes it over ``cuda_emu``: launches through
    ``emu_launch``, dynamic shared memory the stand-in's buffer, static
    shared arrays shared by the block's threads, the inline-PTX
    primitives' definitions dropped."""
    text = re.sub(r"([\w:]+(?:<[^<>;()]*>)?)<<<([^>]*)>>>\(",
                  r"emu_launch(\2, \1, ", text)
    text = text.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_smem;")
    text = re.sub(r"\b__shared__\b", "static", text)
    for name in PRIMS:
        text = re.sub(r"(template <[^\n]*>\n)?__device__ __forceinline__ "
                      r"[^\n]*\b%s\(.*?\n}\n" % name, "", text, flags=re.S)
    return text


def build(out: Path, libs) -> dict:
    """The libraries ``libs`` (names of ``csrc/<name>.cu``) built for the
    host into ``out``: name -> ``ctypes.CDLL`` with the port's argtypes.
    Skips the calling test where there is no g++ with C++20's
    ``<barrier>``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the CPU")
    for src in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (out / src.name).write_text(host_source(src.read_text()))

    def compile_one(name):
        # no strict aliasing: the sources read a 16-bit vector's elements
        # through a cast of the loaded word, as nvcc allows; no
        # contraction: each `a * b + c` a source writes stays two
        # roundings, and only its explicit `fmaf` fuses
        cmd = [gxx, "-x", "c++", "-std=c++20", "-O2", "-fno-strict-aliasing",
               "-ffp-contract=off",
               "-shared", "-fPIC", "-pthread", "-w", f"-I{EMU}", "-include",
               str(EMU / "warp_prims.h"), str(out / f"{name}.cu"), "-o",
               str(out / f"lib{name}.so")]
        return subprocess.run(cmd, capture_output=True, text=True)

    with ThreadPoolExecutor(len(libs)) as pool:
        done = list(pool.map(compile_one, libs))
    if any(r.returncode for r in done):
        if any("barrier" in r.stderr and "No such file" in r.stderr
               for r in done):
            pytest.skip("g++ without C++20's <barrier>")
        raise AssertionError("\n".join(r.stderr for r in done))
    bound = {}
    for name in libs:
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in _build.SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.apex_cuda_error_string.argtypes = [ctypes.c_int]
        lib.apex_cuda_error_string.restype = ctypes.c_char_p
        bound[name] = lib
    return bound


def route(monkeypatch, libs: dict, module) -> None:
    """Make the flash wrappers of ``module`` (the port's
    ``ops.flash_attention``) launch the emulated ``libs`` on CPU tensors,
    with no stream, no device switch and no launch count."""
    monkeypatch.setattr(_build, "library", libs.__getitem__)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(module, "bump", lambda name: None)
