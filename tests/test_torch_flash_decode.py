"""Port parity: ``apex_tpu_torch.ops.flash_decode`` against the JAX
package's ``flash_decode`` (the Pallas ``_decode_paged`` in CPU
interpret mode) on the same numpy cache.

The JAX pool stores d=64 head pairs packed as (nb, h/2, bs, 2d), a TPU
lane layout; the port stores (nb, h, bs, d).  Each case builds one dense
cache, hands JAX its packed form and the port the dense one, and bakes
in the hard rows: an inactive row (seq_len 0, exactly 0 out), a row
straddling a page, a row filling every page, and dump-page padding.

Tolerance 1e-5: fp32 online softmax page by page against the port's
dense fp32 softmax.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_decode import flash_decode as jax_decode
from apex_tpu.ops.flash_decode import pack_decode_heads
from apex_tpu.ops.flash_decode import \
    paged_attention_reference as jax_paged_reference
from apex_tpu_torch.ops import flash_decode, paged_attention_reference

TOL = 1e-5


def _case(b=4, h=2, d=64, nb=12, bs=4, mp=3, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(nb, h, bs, d).astype(np.float32)
    v = rng.randn(nb, h, bs, d).astype(np.float32)
    bt = np.zeros((b, mp), np.int32)           # dump-page padding
    lens = [0, mp * bs - bs // 2 - 1, mp * bs, 1][:b]
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
    return flash_decode(*map(torch.from_numpy, (q, k, v, bt, sl)),
                        **kw).numpy()


@pytest.mark.parametrize("bs", [4, 16])
def test_packed_jax_matches_unpacked_port(bs):
    q, k, v, bt, sl = _case(bs=bs, nb=12, seed=bs)
    kp, vp = _packed(k), _packed(v)
    assert kp.shape == (12, 1, bs, 128)         # the JAX packed layout
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_decode(*map(jnp.asarray,
                                          (q, kp, vp, bt, sl))))
    got = _port(q, k, v, bt, sl)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()                  # seq_len 0: exact zeros


def test_unpacked_d32_matches_jax_and_reference():
    # d=32 is stored unpacked by JAX too; also hold the port's plain
    # version against JAX's dense twin
    q, k, v, bt, sl = _case(b=4, h=3, d=32, nb=10, bs=8, mp=2, seed=5)
    with jax.default_matmul_precision("highest"):
        args = list(map(jnp.asarray, (q, k, v, bt, sl)))
        want = np.asarray(jax_decode(*args, scale=0.2))
        want_ref = np.asarray(jax_paged_reference(*args, scale=0.2))
    got = _port(q, k, v, bt, sl, scale=0.2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)


def test_garbage_past_seq_len_is_ignored():
    q, k, v, bt, sl = _case(seed=9)
    base = _port(q, k, v, bt, sl)
    k2, v2 = k.copy(), v.copy()
    # row 1 straddles its last page: poison the slots past its length
    bs = k.shape[2]
    last, off = divmod(int(sl[1]), bs)
    k2[bt[1, last], :, off:] = 1e9
    v2[bt[1, last], :, off:] = 1e4
    k2[0], v2[0] = 1e9, 1e4                      # the dump page
    got = _port(q, k2, v2, bt, sl)
    np.testing.assert_allclose(got, base, rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()


def test_cpu_wrapper_is_the_plain_version_and_checks_layout():
    q, k, v, bt, sl = map(torch.from_numpy, _case(seed=2))
    assert torch.equal(flash_decode(q, k, v, bt, sl),
                       paged_attention_reference(q, k, v, bt, sl))
    packed = torch.from_numpy(_packed(k.numpy()))
    with pytest.raises(ValueError, match="unpacked"):
        flash_decode(q, packed, packed, bt, sl)
