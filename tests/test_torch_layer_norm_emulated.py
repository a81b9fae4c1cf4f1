"""Rows 1 and 2's LayerNorm forward and backward kernels
(``apex_tpu_torch/csrc/layer_norm.cu``) run on the CPU and are held against
their plain versions, ``layer_norm_stats_reference`` and
``layer_norm_backward_reference``, and each against its other path.

The source is built with g++ over ``tests/cuda_emu`` (``emulate.py``, one
host thread a CUDA thread, warp shuffles through a table of the warp's
lanes).  The launcher's own routing runs: ``ln_fwd_vec_kernel`` (one warp a
row, 16-byte loads, the row in registers, shuffle reductions alone) where
hidden is a multiple of 256 up to 2048 and every pointer is 16-byte
aligned, in each of its register buckets (256, 512, 768 with a pass
guarded off, 1024, 2048), in bf16, fp16 and fp32, with fp32 and x-dtype
gamma/beta and without affine, at row counts that leave a block's last
warps idle; the PR 1 kernel (``ln_fwd_kernel``, one 256-thread block a
row) as the element path, at an odd width and through a view one element
off 16-byte alignment.

The holds: y within ``test_torch_layer_norm.py``'s tolerances of the plain
version (fp32 1e-5, bf16 3e-2, one bf16 ulp at |y| ~ 4; fp16 one fp16 ulp
there, 2^-8), mean and rstd within 1e-5 of it.  And the vector path's y,
mean and rstd must equal, bit for bit, the element path's on the same
values taken through a misaligned view: the vector kernel sums each of
the element path's 256 threads' columns in that thread's order and adds
the partials in its shuffle tree.

The backward's routing is the forward's rule with dy and dx (fp32 x only
up to 1024 columns): the vector path (``ln_bwd_vec_kernel``, a warp a row
walker, 16-byte loads of the next row before the current row's sums,
shuffle sums in ``block_sum2``'s tree, the partials in registers or, where
the rows' words would crowd them out, in the warp's slice of shared
memory) and the element path (``ln_bwd_kernel``, a block a walker).  Both
keep ``parts`` walkers, set here for 2 SMs (8 walkers), so every partial
adds the same rows in the same order: dx, dgamma and dbeta must be equal
bit for bit, at row counts below ``parts`` (a walker a row) and above it
(walkers of two to four rows), in every register bucket and dtype, with
gamma in x's dtype, in fp32 and absent.  The holds against
the plain version: dx within the forward's tolerances, dgamma and dbeta
within ``WGRAD_RTOL`` of their largest value (fp32 sums over other
orders, then one rounding to gamma's dtype).

What these tests cannot show: the stand-in builds with
``-ffp-contract=off``, so it keeps the element path's ``v * g + b`` two
roundings, while nvcc contracts it into the FFMA that the vector kernel
writes as ``fmaf``; with affine, the two paths are compared here on
gamma/beta whose products with the normalised row are exact (powers of
two), where both forms agree.  That the card's vector path gives the
card's element path's bits with any gamma is held there by
``chip_smoke.py`` and ``tools/kernel_variants.py ln``.
"""
import importlib

import numpy as np
import pytest
import torch

from cuda_emu import emulate

ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
TOL = {F32: 1e-5, BF16: 3e-2, F16: 2.0 ** -8}
STAT_TOL = 1e-5
EPS = 1e-5
WGRAD_RTOL = {F32: 1e-5, BF16: 1e-2, F16: 2e-3}
SMS = 2                  # an SM count for the backward's walkers: few, as
PARTS = 4 * SMS          # each element-path walker is 256 host threads


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("layer_norm_emu"),
                         ("layer_norm",))


@pytest.fixture
def launch(emulated, monkeypatch):
    """``layer_norm._launch`` on CPU tensors, through the emulated
    library."""
    emulate.route(monkeypatch, emulated, ln)
    return ln._launch


def _misaligned(t):
    """``t``'s values in a contiguous view one element past a 16-byte
    boundary: the element path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view_as(t)
    assert buf.data_ptr() % 16
    return buf.copy_(t)


def _case(rows, hidden, dtype, w_dtype, seed, pow2_affine=False):
    """x of 3 sigma around 1 in ``dtype`` and gamma/beta in ``w_dtype``
    (None: no affine); with ``pow2_affine`` gamma is a signed power of
    two, so that ``v * g`` is exact."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((3 * rng.randn(rows, hidden) + 1)
                         .astype(np.float32)).to(dtype)
    if w_dtype is None:
        return x, None, None
    if pow2_affine:
        g = np.sign(rng.randn(hidden)) * 2.0 ** rng.randint(-2, 3, hidden)
    else:
        g = rng.randn(hidden)
    b = rng.randn(hidden)
    return (x, torch.from_numpy(g.astype(np.float32)).to(w_dtype),
            torch.from_numpy(b.astype(np.float32)).to(w_dtype))


def _hold(launch, x, gamma, beta):
    y, mean, rstd = launch(x, gamma, beta, EPS)
    yr, mr, rr = ln.layer_norm_stats_reference(x, gamma, beta, EPS)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert mean.shape == rstd.shape == x.shape[:-1]
    tol = TOL[x.dtype]
    np.testing.assert_allclose(y.float().numpy(), yr.float().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(mean.numpy(), mr.numpy(), rtol=STAT_TOL,
                               atol=STAT_TOL)
    np.testing.assert_allclose(rstd.numpy(), rr.numpy(), rtol=STAT_TOL,
                               atol=STAT_TOL)
    return y, mean, rstd


def _bitwise_paths(launch, x, gamma, beta):
    """The vector path (aligned x) and the element path (x through a
    misaligned view) give the same y, mean and rstd."""
    vec = _hold(launch, x, gamma, beta)
    elem = _hold(launch, _misaligned(x), gamma, beta)
    for what, a, b in zip(("y", "mean", "rstd"), vec, elem):
        assert torch.equal(a, b), f"{what}: the paths' bits differ"


AFFINE = [(BF16, F32), (BF16, BF16), (BF16, None), (F16, F32), (F16, F16),
          (F16, None), (F32, F32), (F32, None)]


@pytest.mark.parametrize("dtype,w_dtype", AFFINE)
def test_hidden_1024_every_instantiation(launch, dtype, w_dtype):
    # 6 rows: the second block's last two warps idle
    x, g, b = _case(6, 1024, dtype, w_dtype, seed=1)
    _hold(launch, x, g, b)


@pytest.mark.parametrize("dtype,w_dtype", AFFINE)
def test_vector_path_bitwise_element_path(launch, dtype, w_dtype):
    x, g, b = _case(5, 1024, dtype, w_dtype, seed=2, pow2_affine=True)
    _bitwise_paths(launch, x, g, b)


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("hidden", [256, 512, 768, 2048])
def test_register_buckets(launch, hidden, dtype):
    # one pass (256), two, three of the four-pass bucket's (768), eight;
    # 9 rows: the third block's last three warps idle
    x, g, b = _case(9, hidden, dtype, F32, seed=hidden, pow2_affine=True)
    _bitwise_paths(launch, x, g, b)


@pytest.mark.parametrize("dtype,w_dtype", [(BF16, F32), (F16, F16),
                                           (F32, None)])
def test_element_path_odd_width(launch, dtype, w_dtype):
    # hidden off a multiple of 256, and past the vector path's 2048
    for hidden in (1000, 200, 2304):
        x, g, b = _case(3, hidden, dtype, w_dtype, seed=hidden)
        _hold(launch, x, g, b)


def test_misaligned_gamma_takes_element_path(launch):
    # gamma/beta views off 16 bytes: the element path, with its bits
    x, g, b = _case(4, 512, BF16, F32, seed=7, pow2_affine=True)
    gv, bv = _misaligned(g), _misaligned(b)
    vec = _hold(launch, x, g, b)
    elem = _hold(launch, x, gv, bv)
    for a, c in zip(vec, elem):
        assert torch.equal(a, c)


def test_one_row(launch):
    # the decode tick's shape in miniature: one block, three warps idle
    x, g, b = _case(1, 1024, BF16, F32, seed=11)
    _hold(launch, x, g, b)


# --- backward (row 2) --------------------------------------------------

@pytest.fixture
def launch_bwd(emulated, monkeypatch):
    """``layer_norm._launch_backward`` on CPU tensors, through the
    emulated library, with the stand-in card's SM count."""
    emulate.route(monkeypatch, emulated, ln)
    monkeypatch.setattr(ln, "_sm_count", lambda device: SMS)
    return ln._launch_backward


def _bwd_case(rows, hidden, dtype, w_dtype, seed):
    """x and gamma as ``_case``, dy ~ N(0, 1) in x's dtype, and the
    forward's fp32 mean and rstd."""
    x, g, _ = _case(rows, hidden, dtype, w_dtype, seed)
    rng = np.random.RandomState(seed + 1000)
    dy = torch.from_numpy(rng.randn(rows, hidden).astype(np.float32)) \
        .to(dtype)
    _, mean, rstd = ln.layer_norm_stats_reference(x, None, None, EPS)
    return x, g, dy, mean, rstd


def _hold_bwd(launch_bwd, x, g, dy, mean, rstd):
    dx, dg, db = launch_bwd(x, g, dy, mean, rstd)
    rx, rg, rb = ln.layer_norm_backward_reference(x, g, dy, mean, rstd)
    assert dx.dtype == x.dtype and dx.shape == x.shape
    tol = TOL[x.dtype]
    np.testing.assert_allclose(dx.float().numpy(), rx.float().numpy(),
                               rtol=tol, atol=tol)
    if g is None:
        assert dg is None and db is None
        return dx, dg, db
    for what, a, b in (("dgamma", dg, rg), ("dbeta", db, rb)):
        assert a.dtype == g.dtype and a.shape == g.shape
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        assert err <= WGRAD_RTOL[g.dtype] * scale, \
            f"{what}: {err:.3e} of max {scale:.3e}"
    return dx, dg, db


def _bwd_paths_equal(launch_bwd, x, g, dy, mean, rstd):
    """The vector path (aligned x and dy) and the element path (x through
    a misaligned view) give the same dx, dgamma and dbeta."""
    vec = _hold_bwd(launch_bwd, x, g, dy, mean, rstd)
    elem = _hold_bwd(launch_bwd, _misaligned(x), g, dy, mean, rstd)
    for what, a, b in zip(("dx", "dgamma", "dbeta"), vec, elem):
        assert (a is None and b is None) or torch.equal(a, b), \
            f"{what}: the paths' bits differ"


@pytest.mark.parametrize("dtype,w_dtype", AFFINE)
def test_backward_every_instantiation_bitwise(launch_bwd, dtype, w_dtype):
    # 27 rows over 8 walkers: three or four rows each, the next in flight
    x, g, dy, mean, rstd = _bwd_case(27, 1024, dtype, w_dtype, seed=21)
    _bwd_paths_equal(launch_bwd, x, g, dy, mean, rstd)


@pytest.mark.parametrize("rows", [5, 13])
@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("hidden", [256, 512, 768, 2048])
def test_backward_register_buckets(launch_bwd, hidden, dtype, rows):
    # one pass, two, three of four, eight (the shared-memory partials of
    # 2-byte x; fp32 keeps them there from four passes and takes the
    # element path past 1024 columns); 5 rows: fewer than the walkers,
    # 13: more
    x, g, dy, mean, rstd = _bwd_case(rows, hidden, dtype, F32,
                                     seed=hidden + rows)
    _bwd_paths_equal(launch_bwd, x, g, dy, mean, rstd)


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_backward_no_affine_shared_bucket(launch_bwd, dtype):
    # without gamma no partial is kept, in any bucket
    x, g, dy, mean, rstd = _bwd_case(17, 2048, dtype, None, seed=23)
    _bwd_paths_equal(launch_bwd, x, g, dy, mean, rstd)


def test_backward_misaligned_dy_takes_element_path(launch_bwd):
    # dy one element off 16 bytes: the element path, with its bits
    x, g, dy, mean, rstd = _bwd_case(17, 1024, BF16, BF16, seed=24)
    vec = _hold_bwd(launch_bwd, x, g, dy, mean, rstd)
    elem = _hold_bwd(launch_bwd, x, g, _misaligned(dy), mean, rstd)
    for a, b in zip(vec, elem):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,w_dtype", [(BF16, F32), (F16, F16),
                                           (F32, None)])
def test_backward_element_path_odd_width(launch_bwd, dtype, w_dtype):
    # hidden off a multiple of 256, and past the vector path's 2048
    for hidden in (1000, 2304):
        x, g, dy, mean, rstd = _bwd_case(13, hidden, dtype, w_dtype,
                                         seed=hidden)
        _hold_bwd(launch_bwd, x, g, dy, mean, rstd)


def test_backward_one_row(launch_bwd):
    # one walker, one row: a block with three idle warps
    x, g, dy, mean, rstd = _bwd_case(1, 1024, BF16, F32, seed=25)
    _bwd_paths_equal(launch_bwd, x, g, dy, mean, rstd)
