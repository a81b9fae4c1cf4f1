"""Row 17's tensor-core kernels (``quant_small_kernel`` and
``quant_mma_kernel`` in ``apex_tpu_torch/csrc/quant_matmul.cu``: bf16 /
fp16 x against int8 codes) run on the CPU and are held against their
plain version, ``quant_matmul_reference``.

The source is built with g++ over ``tests/cuda_emu`` (``emulate.py``, one
host thread a CUDA thread; ``cp.async``, ``ldmatrix`` and
``mma.sync.m16n8k16`` with the PTX fragment layouts; a thread-block
cluster's blocks run together, each with its own shared memory).  The
kernels' own code runs: the route by M (up to 32 rows the small kernel,
its codes loaded straight into B fragments and converted in registers;
above, 64 x 128 tiles through a three-stage ring, the codes converted into
a [k][n] tile read by ``ldmatrix.trans``), K split over a cluster where
the tiles are fewer than twice the SMs (the stand-in card has 8), the
warps' and the ranks' sums in their fixed orders through shared and
distributed shared memory, the column scale at the store, and every edge:
M, N and K off the tiles, N or K off the vector loads (the element
loads), an all-zero weight column.

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


def _run(launch, m, k, n, x_dtype=BF16, out_dtype=None, seed=0,
         zero_col=None):
    out_dtype = out_dtype or x_dtype
    x, wq, sc = _case(m, k, n, x_dtype, seed, zero_col)
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
