"""Port parity: ``apex_tpu_torch.ops.flash_decode_multi`` (row 15, the
multi-token paged attention of speculative verify and chunked prefill)
against the JAX package's ``flash_decode_multi`` (the Pallas
``_decode_paged_multi`` in CPU interpret mode) on the same numpy cache.

Each case holds the hard rows: an inactive sequence (seq_len 0, every
row exactly 0), a sequence shorter than the chunk (its first rows sit at
negative positions and are exactly 0), a sequence whose last page is
partly written, and one filling every page, with dump-page padding in
the block tables.  The JAX pool stores d=64 head pairs packed (nb, h/2,
bs, 2d); the port stores (nb, h, bs, d).

Tolerance 1e-5: fp32 online softmax page by page against the port's
dense fp32 softmax.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_decode import flash_decode_multi as jax_multi
from apex_tpu.ops.flash_decode import pack_decode_heads
from apex_tpu.ops.flash_decode import \
    paged_attention_reference as jax_paged_reference
from apex_tpu.ops.flash_decode import \
    paged_attention_multi_reference as jax_multi_reference
from apex_tpu_torch.ops import (flash_decode_multi,
                                paged_attention_multi_reference,
                                paged_attention_reference)

TOL = 1e-5


def _case(t, h=2, d=64, nb=16, bs=4, mp=4, seed=0):
    rng = np.random.RandomState(seed)
    full = mp * bs
    lens = [0, t - 1 if t > 1 else 1, full - bs // 2 - 1, full]
    b = len(lens)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(nb, h, bs, d).astype(np.float32)
    v = rng.randn(nb, h, bs, d).astype(np.float32)
    bt = np.zeros((b, mp), np.int32)           # dump-page padding
    pool = rng.permutation(np.arange(1, nb))
    nxt = 0
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        bt[i, :pages] = pool[nxt:nxt + pages]
        nxt += pages
    return q, k, v, bt, np.asarray(lens, np.int32)


def _packed(dense):
    return np.array(pack_decode_heads(
        jnp.asarray(dense).transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3))


def _port(q, k, v, bt, sl, **kw):
    return flash_decode_multi(*map(torch.from_numpy, (q, k, v, bt, sl)),
                              **kw).numpy()


def _dead(sl, t):
    """(b, t) rows with nothing to attend: negative positions."""
    return (sl[:, None] - t + np.arange(t)[None, :]) < 0


@pytest.mark.parametrize("t", [1, 3, 8])
def test_packed_jax_matches_unpacked_port(t):
    q, k, v, bt, sl = _case(t, seed=t)
    kp, vp = _packed(k), _packed(v)
    assert kp.shape == (16, 1, 4, 128)          # the JAX packed layout
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_multi(*map(jnp.asarray,
                                         (q, kp, vp, bt, sl))))
    got = _port(q, k, v, bt, sl)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    dead = _dead(sl, t)
    assert dead[0].all() and dead.sum() >= t    # inactive + short rows
    assert (got[dead] == 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("t", [1, 3, 8])
def test_unpacked_d32_matches_jax_and_reference(t):
    # d=32 is stored unpacked by JAX too; also hold the port's plain
    # version against JAX's dense twin
    q, k, v, bt, sl = _case(t, h=3, d=32, nb=20, bs=8, mp=3, seed=10 + t)
    with jax.default_matmul_precision("highest"):
        args = list(map(jnp.asarray, (q, k, v, bt, sl)))
        want = np.asarray(jax_multi(*args, scale=0.2))
        want_ref = np.asarray(jax_multi_reference(*args, scale=0.2))
    got = _port(q, k, v, bt, sl, scale=0.2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)
    assert (got[_dead(sl, t)] == 0).all()


def test_t1_equals_single_token_decode():
    # at t = 1 the multi-token path is the decode path: the port's
    # against JAX's single-token dense twin, and the port's single-token
    # plain version against its multi-token one
    q, k, v, bt, sl = _case(1, seed=3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_paged_reference(*map(jnp.asarray, (
            q[:, 0], k, v, bt, sl))))
    got = _port(q, k, v, bt, sl)[:, 0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    tq, tk, tv, tbt, tsl = map(torch.from_numpy, (q, k, v, bt, sl))
    assert torch.equal(paged_attention_reference(tq[:, 0], tk, tv, tbt, tsl),
                       torch.from_numpy(got))


def test_garbage_past_each_row_limit_is_ignored():
    t = 3
    q, k, v, bt, sl = _case(t, seed=9)
    base = _port(q, k, v, bt, sl)
    bs = k.shape[2]
    # poison every slot past each sequence's length, and the dump page:
    # row r of sequence b reads no position past sl[b] - t + r, and the
    # chunk's own slots below sl[b] are real (written before attending)
    k2, v2 = k.copy(), v.copy()
    for i, n in enumerate(sl):
        for pos in range(int(n), bt.shape[1] * bs):
            page, off = divmod(pos, bs)
            if bt[i, page]:
                k2[bt[i, page], :, off] = 1e9
                v2[bt[i, page], :, off] = 1e4
    k2[0], v2[0] = 1e9, 1e4
    got = _port(q, k2, v2, bt, sl)
    np.testing.assert_allclose(got, base, rtol=TOL, atol=TOL)
    # and the per-row limit inside the chunk: poisoning position
    # sl - 1 (the chunk's last row) moves only that row
    i = 3                                       # the full sequence
    page, off = divmod(int(sl[i]) - 1, bs)
    k2[bt[i, page], :, off] = 50.0
    moved = _port(q, k2, v2, bt, sl)
    np.testing.assert_allclose(moved[i, :t - 1], base[i, :t - 1],
                               rtol=TOL, atol=TOL)
    assert np.abs(moved[i, t - 1] - base[i, t - 1]).max() > 1e-3


def test_cpu_wrapper_is_the_plain_version_and_checks_layout():
    q, k, v, bt, sl = map(torch.from_numpy, _case(3, seed=2))
    assert torch.equal(flash_decode_multi(q, k, v, bt, sl),
                       paged_attention_multi_reference(q, k, v, bt, sl))
    packed = torch.from_numpy(_packed(k.numpy()))
    with pytest.raises(ValueError, match="unpacked"):
        flash_decode_multi(q, packed, packed, bt, sl)
    with pytest.raises(ValueError, match=r"\(b, t, h, d\)"):
        flash_decode_multi(q[:, 0], k, v, bt, sl)
