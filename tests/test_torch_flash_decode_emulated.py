"""The paged decode's kernels (row 14's ``decode_kernel`` and row 15's
``decode_multi_kernel``, with their merge ``decode_multi_combine``, in
``apex_tpu_torch/csrc/flash_decode.cu``) run on the CPU and are held
against their plain versions, ``paged_attention_reference`` and
``paged_attention_multi_reference``.

Row 15 runs by each of its routes: up to 4 query rows (t = 1, 3: every
warp owns all the rows and the warps split the keys, merging in shared
memory) and from 5 (t = 6, which leaves two warps of the block without
rows, 16, 32: each warp owns 4 rows and walks every key), at d 64 and 128,
bs 16 and 5 (t past bs), a float and an int8 cache and every other dtype
pair, q through strided views, many splits and one (the output written
directly), with front padding (seq_len < t), a seq_len-0 row, a limit
mid-page and a cache view off 16 bytes (copied by the wrapper).

The source is built with g++ over ``tests/cuda_emu`` (``emulate.py``, one
host thread a CUDA thread).  The kernel's own code runs: the split of a
row's positions (its count from the C entry, as on the card), the span's
page ids, the 16-byte loads of each lane group and their conversion for
every cache dtype, the group's online softmax, the butterfly merges of the
groups and the warps, the second pass over the splits, the int8 scales on
the score and on p, and the edge rows: seq_len 0 (exactly 0), a page
straddled, a row filling every page, a row over many splits.  What the
card adds (timing, ``exp2f``'s last bits) is held there by
``chip_smoke.py``.

The hold: each element within one ulp of the output dtype (2^-7 of the
reference in bf16, 2^-10 in fp16, 0 in fp32) plus ``ATOL`` of fp32 noise
(both sides sum in fp32 in other orders and round once), under
``chip_smoke.py``'s ``DECODE_TOL`` as well; a second call must give the
same bits.
"""
import importlib

import numpy as np
import pytest
import torch

from cuda_emu import emulate

fd = importlib.import_module("apex_tpu_torch.ops.flash_decode")

ULP_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
            torch.float32: 0.0}
ATOL = 1e-5
DECODE_TOL = 1e-2
F32, BF16, F16, I8 = torch.float32, torch.bfloat16, torch.float16, torch.int8


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("flash_decode_emu"),
                         ("flash_decode",))


@pytest.fixture
def lib(emulated, monkeypatch):
    """``flash_decode``'s wrappers launch the emulated library on CPU
    tensors."""
    emulate.route(monkeypatch, emulated, fd)
    return emulated["flash_decode"]


def _cache(lens, h, d, bs, mp, q_dtype, cache_dtype, seed, t=None):
    """q, a cache of random pages with a block table giving each row of
    ``lens`` its own pages (page 0 the dump page past them), seq_lens, and
    the scales of an int8 cache."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    nb = sum(-(-n // bs) for n in lens) + 2
    qshape = (b, h, d) if t is None else (b, t, h, d)
    q = torch.from_numpy(rng.randn(*qshape).astype(np.float32)).to(q_dtype)
    kc, vc = (torch.from_numpy(rng.randn(nb, h, bs, d).astype(np.float32))
              for _ in "kv")
    kw = {}
    if cache_dtype == I8:
        from apex_tpu_torch.serving import quantize_kv_rows

        (kc, ks), (vc, vs) = quantize_kv_rows(kc), quantize_kv_rows(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.to(cache_dtype), vc.to(cache_dtype)
    pool = rng.permutation(np.arange(1, nb))
    bt = np.zeros((b, mp), np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        bt[i, :pages] = pool[nxt:nxt + pages]
        nxt += pages
    return (q, kc, vc, torch.from_numpy(bt),
            torch.tensor(lens, dtype=torch.int32), kw)


def _hold(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all(), "not finite"
    diff = (got.float() - want.float()).abs()
    excess = float((diff - ULP_RTOL[got.dtype] * want.float().abs()).max())
    assert excess <= ATOL, f"{excess:.3e} past one ulp"
    assert float(diff.max()) <= DECODE_TOL


def _decode(lib, lens, h, d, bs, mp, q_dtype, cache_dtype, seed=0,
            splits_at_least=1):
    q, kc, vc, bt, sl, kw = _cache(lens, h, d, bs, mp, q_dtype, cache_dtype,
                                   seed)
    scale = d ** -0.5
    splits = lib.apex_flash_decode_splits(len(lens), h, bs, mp)
    assert splits >= splits_at_least
    got = fd._launch(q, kc, vc, kw.get("k_scale"), kw.get("v_scale"), bt,
                     sl, scale)
    want = fd.paged_attention_reference(q, kc, vc, bt, sl, scale=scale,
                                        **kw)
    _hold(got, want)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any(), "a seq_len-0 row is not exactly 0"
    again = fd._launch(q, kc, vc, kw.get("k_scale"), kw.get("v_scale"), bt,
                       sl, scale)
    assert torch.equal(got, again), "a second call gave other bits"
    return got


# row 0 inactive, row 1 straddles a page, row 2 fills every page (over
# several splits), row 3 a single key
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("q_dtype,cache_dtype", [(BF16, BF16), (BF16, I8)])
def test_serve_lanes(lib, d, q_dtype, cache_dtype):
    bs, mp = 16, 12
    _decode(lib, [0, 16 * 5 + 7, mp * bs, 1], 2, d, bs, mp, q_dtype,
            cache_dtype, seed=d, splits_at_least=3)


@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (F32, F32), (F32, BF16), (F32, I8), (F16, F16), (F16, I8)])
def test_dtype_pairs(lib, q_dtype, cache_dtype):
    # the other five pairs decode_dispatch takes, an odd block size
    bs, mp = 5, 16
    _decode(lib, [33, 0, mp * bs], 2, 64, bs, mp, q_dtype, cache_dtype,
            seed=7)


@pytest.mark.parametrize("cache_dtype", (BF16, I8))
def test_long_row_many_splits(lib, cache_dtype):
    # one row: the splits spread it (64 positions each), the merge takes
    # twenty of them in order; a second row ends inside the fourth split
    bs, mp = 16, 80
    _decode(lib, [mp * bs, 200], 1, 64, bs, mp, BF16, cache_dtype, seed=3,
            splits_at_least=20)


def test_strided_q(lib):
    # q a view with a head stride of 2d, as the serve's qkv slices it
    bs, mp, h, d = 16, 8, 2, 64
    q, kc, vc, bt, sl, _ = _cache([100, 0, 128], h, d, bs, mp, BF16, BF16, 9)
    wide = torch.zeros(3, h, 2 * d, dtype=BF16)
    wide[..., d:] = q
    qv = wide[..., d:]
    assert not qv.is_contiguous()
    got = fd._launch(qv, kc, vc, None, None, bt, sl, d ** -0.5)
    _hold(got, fd.paged_attention_reference(q, kc, vc, bt, sl))


def test_multi_t1_matches_decode(lib):
    # row 15's kernel at t = 1 against row 14's, and at t = 3 against its
    # plain version (front padding and the dead row exactly 0)
    bs, mp, h, d = 16, 12, 2, 64
    lens = [0, 2, 16 * 5 + 7, mp * bs]
    q, kc, vc, bt, sl, _ = _cache(lens, h, d, bs, mp, BF16, BF16, 11, t=3)
    scale = d ** -0.5
    one = fd._launch_multi(q[:, :1], kc, vc, None, None, bt, sl, scale)[:, 0]
    dec = fd._launch(q[:, 0].contiguous(), kc, vc, None, None, bt, sl,
                     scale)
    _hold(one, dec)
    got = fd._launch_multi(q, kc, vc, None, None, bt, sl, scale)
    _hold(got, fd.paged_attention_multi_reference(q, kc, vc, bt, sl))
    assert not got[0].any() and not got[1, 0].any()


def test_misaligned_cache_view_is_copied(lib):
    # a contiguous cache view whose data starts 2 bytes off 16: the
    # wrapper hands the kernel a copy (its rows are read 16 bytes at a
    # time, and the C entry refuses such a pointer)
    bs, mp, h, d = 16, 8, 2, 64
    q, kc, vc, bt, sl, _ = _cache([100, 0, 128], h, d, bs, mp, BF16, BF16, 13)
    flat = torch.empty(kc.numel() + 1, dtype=BF16)
    flat[1:] = kc.flatten()
    kv = flat[1:].view(kc.shape)
    assert kv.is_contiguous() and kv.data_ptr() % 16
    got = fd._launch(q, kv, vc, None, None, bt, sl, d ** -0.5)
    _hold(got, fd.paged_attention_reference(q, kc, vc, bt, sl))


def _multi(lib, lens, t, h, d, bs, mp, q_dtype, cache_dtype, seed=0,
           splits=None):
    """Row 15 on one case through the wrapper's launcher, held element by
    element and to ``DECODE_TOL`` against its plain version; rows at a
    negative position exactly 0; a second call bitwise equal.  ``splits``:
    the count the C side must plan."""
    q, kc, vc, bt, sl, kw = _cache(lens, h, d, bs, mp, q_dtype, cache_dtype,
                                   seed, t=t)
    b = len(lens)
    if splits is not None:
        assert lib.apex_flash_decode_multi_plan(b, t, h, bs, mp) == splits
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    got = fd._launch_multi(q, kc, vc, ks, vs, bt, sl, d ** -0.5)
    _hold(got, fd.paged_attention_multi_reference(q, kc, vc, bt, sl, **kw))
    qpos = sl.long()[:, None] - t + torch.arange(t)[None, :]
    assert not got[qpos < 0].any(), "a row with nothing to attend is not 0"
    again = fd._launch_multi(q, kc, vc, ks, vs, bt, sl, d ** -0.5)
    assert torch.equal(got, again), "a second call gave other bits"
    return q, kc, vc, bt, sl, kw, got


# row 0 inactive, row 1 front-padded (seq_len < t), row 2 ends mid-page,
# row 3 fills every page
@pytest.mark.parametrize("t", (1, 3, 6, 16, 32))
@pytest.mark.parametrize("d", (64, 128))
@pytest.mark.parametrize("cache_dtype", (BF16, I8))
def test_multi_routes(lib, t, d, cache_dtype):
    bs, mp = 16, 12
    _multi(lib, [0, t // 2, 16 * 5 + 7, mp * bs], t, 2, d, bs, mp, BF16,
           cache_dtype, seed=t + d, splits=3)


@pytest.mark.parametrize("t", (3, 16))
@pytest.mark.parametrize("q_dtype,cache_dtype", [
    (F32, F32), (F32, BF16), (F32, I8), (F16, F16), (F16, I8)])
def test_multi_dtype_pairs(lib, t, q_dtype, cache_dtype):
    # the other five pairs multi_dispatch takes; bs 5, so t = 16 spans
    # pages and rows end pages before the last row does
    bs, mp = 5, 16
    _multi(lib, [33, 0, 4, mp * bs], t, 2, 64, bs, mp, q_dtype, cache_dtype,
           seed=t)


@pytest.mark.parametrize("t", (3, 16))
def test_multi_one_split(lib, t):
    # four pages: one split, the rows' outputs written by the first pass
    bs, mp = 16, 4
    _multi(lib, [0, 2, 16 * 2 + 9, mp * bs], t, 2, 64, bs, mp, BF16, BF16,
           seed=5, splits=1)


@pytest.mark.parametrize("cache_dtype", (BF16, I8))
def test_multi_many_splits(lib, cache_dtype):
    # one head of one row: twenty splits of four pages merged in order; a
    # second row ends inside the fourth
    bs, mp = 16, 80
    _multi(lib, [mp * bs, 200], 3, 1, 64, bs, mp, BF16, cache_dtype, seed=8,
           splits=20)


@pytest.mark.parametrize("t", (3, 16))
def test_multi_strided_q(lib, t):
    # q a view of the extend step's qkv: strides on b, t and h past d
    bs, mp, h, d = 16, 8, 2, 64
    q, kc, vc, bt, sl, _ = _cache([100, 0, t - 1, 128], h, d, bs, mp, BF16,
                                  BF16, 21, t=t)
    wide = torch.zeros(4, t, h, 3 * d, dtype=BF16)
    wide[..., d:2 * d] = q
    qv = wide[..., d:2 * d]
    assert not qv.is_contiguous()
    got = fd._launch_multi(qv, kc, vc, None, None, bt, sl, d ** -0.5)
    _hold(got, fd.paged_attention_multi_reference(q, kc, vc, bt, sl))


@pytest.mark.parametrize("t", (3, 16))
def test_multi_misaligned_cache_view_is_copied(lib, t):
    # a contiguous cache view 2 bytes off 16: the wrapper hands the kernel
    # a copy, and the C entry refuses the pointer itself
    bs, mp, h, d = 16, 8, 2, 64
    q, kc, vc, bt, sl, _ = _cache([100, 0, 128], h, d, bs, mp, BF16, BF16,
                                  23, t=t)
    flat = torch.empty(vc.numel() + 1, dtype=BF16)
    flat[1:] = vc.flatten()
    vv = flat[1:].view(vc.shape)
    assert vv.is_contiguous() and vv.data_ptr() % 16
    got = fd._launch_multi(q, kc, vv, None, None, bt, sl, d ** -0.5)
    _hold(got, fd.paged_attention_multi_reference(q, kc, vc, bt, sl))
    out = torch.empty_like(q)
    rc = lib.apex_flash_decode_multi(
        q.data_ptr(), kc.data_ptr(), vv.data_ptr(), None, None,
        bt.data_ptr(), sl.data_ptr(), None, None, out.data_ptr(), 3, t, h,
        d, bs, mp, q.stride(0), q.stride(1), q.stride(2), d ** -0.5, 1, 1,
        None)
    assert rc != 0, "a misaligned cache pointer was taken"


@pytest.mark.parametrize("cache_dtype", (BF16, I8))
@pytest.mark.parametrize("d", (64, 128))
def test_multi_t1_matches_decode_everywhere(lib, cache_dtype, d):
    # t = 1 through row 15 against row 14, element by element
    bs, mp, h = 16, 12, 2
    lens = [0, 1, 16 * 5 + 7, mp * bs]
    q, kc, vc, bt, sl, kw = _cache(lens, h, d, bs, mp, BF16, cache_dtype,
                                   31, t=1)
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    one = fd._launch_multi(q, kc, vc, ks, vs, bt, sl, d ** -0.5)[:, 0]
    dec = fd._launch(q[:, 0].contiguous(), kc, vc, ks, vs, bt, sl,
                     d ** -0.5)
    _hold(one, dec)
    assert not one[0].any()
