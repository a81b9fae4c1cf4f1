"""Rows 16 and 17's tensor-core kernels (``quant_gemv_mma_kernel``,
``quant_small_kernel`` and ``quant_mma_kernel`` in
``apex_tpu_torch/csrc/quant_matmul.cu``: bf16 / fp16 x against int8 codes)
run on the CPU and are held against their plain version,
``quant_matmul_reference``.

The source is built with g++ over ``tests/cuda_emu`` (``emulate.py``, one
host thread a CUDA thread; ``cp.async``, ``ldmatrix`` and
``mma.sync.m16n8k16`` with the PTX fragment layouts; a thread-block
cluster's blocks run together, each with its own shared memory).  The
kernels' own code runs: the route by M (up to 8 rows the GEMV, outᵀ =
wqᵀ · xᵀ with 16-byte code and x loads as its fragments; up to 32 the
small kernel, its codes loaded straight into B fragments and converted in
registers; above, 64 x 128 tiles through a three-stage ring), K split over
a cluster where the tiles are fewer than the SMs (the stand-in card has
8), the warps' and the ranks' sums in their fixed orders through shared and
distributed shared memory, the column scale at the store, and every edge:
M, N and K off the tiles, N or K off the vector loads or a misaligned
pointer (the element loads), an all-zero weight column.

The hold is ``chip_smoke.py``'s: both sides form the same exact products
and sum them in fp32 in other orders, so an fp32 out within ``REL_TOL`` of
its largest value, a bf16 / fp16 out within one ulp of each element beyond
that same slack; a second call must give the same bits.
"""
import importlib

import numpy as np
import pytest
import torch

from cuda_emu import emulate

qm = importlib.import_module("apex_tpu_torch.ops.quant_matmul")

REL_TOL = 1e-5
MANT = {torch.bfloat16: 7, torch.float16: 10}
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("quant_matmul_emu"),
                         ("quant_matmul",))


@pytest.fixture
def launch(emulated, monkeypatch):
    """``quant_matmul._launch`` on CPU tensors, through the emulated
    library."""
    emulate.route(monkeypatch, emulated, qm)
    return qm._launch


def _case(m, k, n, x_dtype, seed, zero_col=None):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(0.02 * rng.randn(k, n).astype(np.float32))
    if zero_col is not None:
        w[:, zero_col] = 0.0
    wq, sc = qm.quantize_weight(w.to(BF16))
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(x_dtype)
    return x, wq, sc


def _hold(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all(), "not finite"
    slack = REL_TOL * float(want.float().abs().max())
    diff = (got.float() - want.float()).abs()
    if got.dtype == F32:
        assert float(diff.max()) <= slack, f"{float(diff.max()):.3e}"
        return
    mag = torch.maximum(got.float().abs(), want.float().abs()) \
        .clamp(min=2.0 ** -126)
    ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - MANT[got.dtype])
    u = float(((diff - slack).clamp(min=0.0) / ulp).max())
    assert u <= 1.0, f"{u:.3f} ulps beyond {slack:.2e}"


def _misaligned(t):
    """``t``'s values in a view one element past an aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view_as(t)
    return buf.copy_(t)


def _run(launch, m, k, n, x_dtype=BF16, out_dtype=None, seed=0,
         zero_col=None, misalign=()):
    out_dtype = out_dtype or x_dtype
    x, wq, sc = _case(m, k, n, x_dtype, seed, zero_col)
    if "x" in misalign:
        x = _misaligned(x)
    if "wq" in misalign:
        wq = _misaligned(wq)
    got = launch(x, wq, sc, out_dtype)
    _hold(got, qm.quant_matmul_reference(x, wq, sc, out_dtype=out_dtype))
    assert torch.equal(got, launch(x, wq, sc, out_dtype)), \
        "a second call gave other bits"
    return got


# 9..32 rows: the small kernel (K = 512 split over 4 blocks, 256 over 2,
# 96 not); 33 and 100: the staged tiles; ragged M, N, K throughout
@pytest.mark.parametrize("m,k,n", [
    (9, 512, 64), (16, 256, 160), (24, 96, 80), (32, 512, 192),
    (33, 128, 96), (100, 192, 64)])
def test_route_boundaries(launch, m, k, n):
    _run(launch, m, k, n, seed=m)


def test_staged_tiles_split(launch):
    # six 64 x 128 tiles, K split over 2 blocks of a cluster, and the M
    # edge of the third row of tiles
    _run(launch, 129, 256, 256, seed=5)


@pytest.mark.parametrize("m,k,n,x_dtype,out_dtype", [
    (24, 77, 100, BF16, BF16), (40, 77, 100, F16, F32),
    (12, 200, 72, F16, F16), (70, 136, 40, BF16, F32)])
def test_element_loads(launch, m, k, n, x_dtype, out_dtype):
    # N or K off the 16-byte vector: the stages load element by element
    _run(launch, m, k, n, x_dtype, out_dtype, seed=k)


@pytest.mark.parametrize("m,x_dtype,out_dtype", [
    (20, BF16, BF16), (20, F16, F32), (64, BF16, BF16), (64, F16, F16)])
def test_zero_column(launch, m, x_dtype, out_dtype):
    got = _run(launch, m, 128, 160, x_dtype, out_dtype, seed=3, zero_col=37)
    assert not got[:, 37].any(), "the all-zero column is not exactly 0"


# --- row 16, the GEMV (M <= 8) -------------------------------------------

@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (BF16, BF16), (F16, F16), (BF16, F32), (F16, F32)])
def test_gemv_rows(launch, m, x_dtype, out_dtype):
    # one 128-column strip, K = 256 split over 2 blocks
    _run(launch, m, 256, 128, x_dtype, out_dtype, seed=m)


# The launcher's K splits (one cluster a strip, at most 8, each warp at
# least one 32-row chunk, toward one block an SM of the stand-in's 8, or
# two where two leave at most an eighth of them without a second) and
# block size (4 warps where each then takes at most a pair of chunks, else
# 8): K = 1024 at one strip takes 8 splits of 4 warps and K = 4096 8 of 8,
# as GPT-345M's decode linears at K = 1024 (dense, fc1) and 4096 (fc2) do
# on the H100; K = 2048 gives each of 4 warps a pair of chunks, K = 512 4
# splits, three strips of K = 1024 2 (as qkv stops at 4 there), two strips
# of K = 4096 8 of 8 warps (two blocks on every SM).
@pytest.mark.parametrize("m,k,n,x_dtype", [
    (8, 1024, 128, BF16), (8, 4096, 128, F16), (4, 2048, 128, BF16),
    (5, 512, 96, BF16), (6, 1024, 384, F16), (3, 4096, 256, BF16)])
def test_gemv_splits(launch, m, k, n, x_dtype):
    _run(launch, m, k, n, x_dtype, seed=k + m)


@pytest.mark.parametrize("m,k,n,x_dtype,out_dtype", [
    (5, 77, 100, BF16, BF16), (8, 1000, 200, F16, F32),
    (2, 96, 131, F16, F16), (7, 333, 48, BF16, F32)])
def test_gemv_element_loads(launch, m, k, n, x_dtype, out_dtype):
    # N off 16 or K off 8: the codes and x load by element, with the K
    # tail ending the last chunk early
    _run(launch, m, k, n, x_dtype, out_dtype, seed=n)


@pytest.mark.parametrize("misalign", [("x",), ("wq",), ("x", "wq")])
def test_gemv_misaligned(launch, misalign):
    _run(launch, 6, 512, 256, BF16, seed=7, misalign=misalign)


@pytest.mark.parametrize("m,x_dtype,out_dtype", [
    (8, BF16, BF16), (3, F16, F32), (1, F16, F16)])
def test_gemv_zero_column(launch, m, x_dtype, out_dtype):
    got = _run(launch, m, 512, 160, x_dtype, out_dtype, seed=11,
               zero_col=37)
    assert not got[:, 37].any(), "the all-zero column is not exactly 0"
