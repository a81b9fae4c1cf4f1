"""Port parity for the dropout lanes of rows 10-13: attention dropout in
``apex_tpu_torch.ops.flash_attention_e`` against the JAX package's
``flash_attention_e(..., dropout_rate, dropout_seed)`` (the Pallas
``_flash_fwd_e`` / ``_flash_bwd_e`` and their blocked walks in CPU
interpret mode, or ``_fallback_dropout_attention``), on the same numpy
inputs, fp32, HIGHEST matmul precision.  On the CPU the port runs the
plain versions, whose keep mask is :func:`rand_keep`.

* The mask: ``rand_keep`` against JAX's ``_rand_keep`` bit for bit, tile
  by tile, in the three forms ``_e_mode(s, h, d, drop=True)`` picks (the
  single block hashes rows with the 128-padded s as stride, the blocked
  walk salts (512, 512) tiles, the fallback hashes (s, s)), with a seed
  near 2^31 and s not a multiple of 128; the fallback's mask is read out
  of ``_fallback_dropout_attention`` itself (zero q and k, identity v).
  ``e_mode`` against ``_e_mode`` on a grid of shapes.
* The forward and dqkv at (2, 100, 4, 64) causal and full (rate 0.3),
  (1, 1152, 2, 64) causal (blocked, rate 0.2), s 128 and 1152 with a
  kv_mask holding a dead row, (1, 64, 2, 128) and (1, 64, 3, 64) (the
  fallback).  Tolerances as ``test_torch_flash_attention_e.py``'s: o
  2e-5, dqkv 1e-4.  The JAX kernels multiply by 1 / (1 - rate), the
  fallback divides by 1 - rate: an ulp apart, inside both.
* Rate 0 is bitwise the dropout-free call; another seed drops other
  pairs; a rate without a seed raises, as in JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import (_e_mode,
                                          _fallback_dropout_attention,
                                          _rand_keep)
from apex_tpu.ops.flash_attention import \
    flash_attention_e as jax_flash_attention_e
from apex_tpu_torch.ops import (dropout_seed, e_mode, flash_attention_e,
                                flash_attention_e_backward,
                                flash_attention_e_with_lse, rand_keep)
from apex_tpu_torch.ops.flash_attention import _e_counter

O_TOL = 2e-5
GRAD_TOL = 1e-4


def _jax_keep_tiles(b, h, s, seed, rate, width, tiled):
    """JAX's keep mask for (b, h, s, s), assembled from ``_rand_keep``
    tiles of ``width`` (salted by their block indices when ``tiled``)."""
    nb = -(-s // width)
    out = np.zeros((b, h, nb * width, nb * width), bool)
    for bi in range(b):
        for hd in range(h):
            for i in range(nb):
                for j in range(nb):
                    ij = (i, j) if tiled else (0, 0)
                    out[bi, hd, i * width:(i + 1) * width,
                        j * width:(j + 1) * width] = np.asarray(_rand_keep(
                            (width, width), seed, bi, hd, *ij, rate))
    return out[..., :s, :s]


@pytest.mark.parametrize("b,h,s,seed,rate", [
    (2, 4, 100, 1234, 0.3),            # s pads to 128: the stride is 128
    (1, 2, 1024, 2 ** 31 - 2, 0.1),    # one whole block, a seed near 2^31
])
def test_single_block_mask_matches_jax(b, h, s, seed, rate):
    assert e_mode(s, h, 64, drop=True) == "single"
    want = _jax_keep_tiles(b, h, s, seed, rate, -(-s // 128) * 128, False)
    got = rand_keep(b, h, s, s, seed, rate, "single")
    assert got.shape == (b, h, s, s) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(float(got.float().mean()) - (1 - rate)) < 0.02


def test_blocked_mask_matches_jax_tile_by_tile():
    b, h, s, seed, rate = 2, 2, 1152, 2 ** 31 - 2, 0.1
    assert e_mode(s, h, 64, drop=True) == "blocked"
    want = _jax_keep_tiles(b, h, s, seed, rate, 512, True)
    got = rand_keep(b, h, s, s, seed, rate, "blocked")
    np.testing.assert_array_equal(got.numpy(), want)
    # the tile salts matter: the unsalted single form differs
    assert not torch.equal(got, rand_keep(b, h, s, s, seed, rate,
                                          "single"))


@pytest.mark.parametrize("s", [100, 64])
def test_fallback_mask_matches_jax(s):
    b, h, seed, rate = 2, 3, 77, 0.25
    assert e_mode(s, h, 64, drop=True) == "fallback"
    assert _e_mode(s, h, 64, drop=True)[0] is None
    # zero scores give every key p = 1 / s; v the identity reads each
    # (q, k) pair's keep bit out of o
    zeros = jnp.zeros((b, h, s, 1), jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(s, dtype=jnp.float32), (b, h, s, s))
    with jax.default_matmul_precision("highest"):
        o = _fallback_dropout_attention(zeros, zeros, eye, 1.0, False, None,
                                        rate, seed)
    want = np.asarray(o) != 0
    got = rand_keep(b, h, s, s, seed, rate, "fallback")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [64, 100, 128, 512, 1024, 1152, 2048, 9000,
                               40000])
@pytest.mark.parametrize("h,d", [(16, 64), (2, 64), (3, 64), (4, 64),
                                 (8, 128), (1, 128), (16, 16)])
def test_e_mode_matches_jax(s, h, d):
    for drop in (False, True):
        want = _e_mode(s, h, d, drop=drop)[0] or "fallback"
        assert e_mode(s, h, d, drop=drop) == want, (s, h, d, drop)


def _inputs(b, s, h, d, seed):
    rng = np.random.RandomState(seed)
    qkv = (0.5 * rng.randn(b, s, h, 3 * d)).astype(np.float32)
    do = rng.randn(b, s, h * d).astype(np.float32)
    return qkv, do


def _dead_row_mask(b, s, seed):
    """(b, s) fp32: row 0 full, the last row all pad, the others padded
    past a seeded length."""
    rng = np.random.RandomState(seed)
    kv = np.zeros((b, s), np.float32)
    kv[0] = 1.0
    for r in range(1, b - 1):
        kv[r, :rng.randint(s // 4, s - 1)] = 1.0
    return kv


def _run(qkv, do, causal, rate, seed, kv=None):
    """JAX's and the port's o and dqkv for one call."""
    d = qkv.shape[-1] // 3
    jm = None if kv is None else jnp.asarray(kv)
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda t: jax_flash_attention_e(
            t, scale=d ** -0.5, causal=causal, kv_mask=jm,
            dropout_rate=rate, dropout_seed=seed), jnp.asarray(qkv))
        dqkv_j, = vjp(jnp.asarray(do))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    o_t = flash_attention_e(qt, causal=causal, kv_mask=None if kv is None
                            else torch.from_numpy(kv), dropout_rate=rate,
                            dropout_seed=seed)
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=O_TOL, atol=O_TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    return o_t.detach(), qt.grad


@pytest.mark.parametrize("b,s,h,d,causal,rate,mode", [
    (2, 100, 4, 64, True, 0.3, "single"),
    (2, 100, 4, 64, False, 0.3, "single"),
    (1, 1152, 2, 64, True, 0.2, "blocked"),
    (1, 64, 2, 128, True, 0.3, "single"),
    (1, 64, 3, 64, True, 0.3, "fallback"),
])
def test_forward_and_grad_match_jax(b, s, h, d, causal, rate, mode):
    assert e_mode(s, h, d, drop=True) == mode
    qkv, do = _inputs(b, s, h, d, seed=s + h + d)
    seed = 12345 + s
    o, _ = _run(qkv, do, causal, rate, seed)
    # dropout took effect: the dropout-free output differs
    plain = flash_attention_e(torch.from_numpy(qkv), causal=causal)
    assert float((plain - o).abs().max()) > 1e-2


@pytest.mark.parametrize("s,causal", [(128, False), (128, True),
                                      (1152, False)])
def test_kv_mask_lane_matches_jax(s, causal):
    b, h, d = 3, 2, 64
    qkv, do = _inputs(b, s, h, d, seed=s + 7)
    kv = _dead_row_mask(b, s, seed=s)
    o, dqkv = _run(qkv, do, causal, 0.2, 99, kv)
    # the all-pad row attends nothing: exact zeros, no NaN
    assert (o[-1] == 0).all() and (dqkv[-1] == 0).all()
    assert torch.isfinite(dqkv).all()
    # a masked key of a live row gets no dk, dv
    pad = torch.from_numpy(kv[1] == 0)
    assert (dqkv[1][pad][..., d:] == 0).all()


def test_rate_zero_is_the_dropout_free_call_bitwise():
    qkv, do = (torch.from_numpy(a) for a in _inputs(2, 100, 4, 64, seed=1))
    o0, lse0 = flash_attention_e_with_lse(qkv, causal=True)
    for seed in (None, 5):
        o, lse = flash_attention_e_with_lse(qkv, causal=True,
                                            dropout_rate=0.0,
                                            dropout_seed=seed)
        assert torch.equal(o, o0) and torch.equal(lse, lse0)
    o4 = o0.view(2, 100, 4, 64)
    do4 = do.view(2, 100, 4, 64)
    assert torch.equal(
        flash_attention_e_backward(qkv, o4, lse0, do4, causal=True),
        flash_attention_e_backward(qkv, o4, lse0, do4, causal=True,
                                   dropout_rate=0.0, dropout_seed=3))
    # the counters keep their names at rate 0
    assert _e_counter(100, None) == "flash_attention_e"
    assert _e_counter(100, None, drop=True) == "flash_attention_e_dropout"
    assert _e_counter(100, qkv, drop=True) == "flash_attention_e_dropout"
    assert _e_counter(1152, None, bwd=True, drop=True) == \
        "flash_attention_e_bwd_blocked_dropout"


def test_seeds_rates_and_errors():
    qkv, _ = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 64, seed=2))
    o1, lse1 = flash_attention_e_with_lse(qkv, dropout_rate=0.1,
                                          dropout_seed=1)
    o2, lse2 = flash_attention_e_with_lse(qkv, dropout_rate=0.1,
                                          dropout_seed=2)
    assert not torch.equal(o1, o2)
    assert torch.equal(lse1, lse2)          # lse is the undropped one
    assert not torch.equal(rand_keep(1, 2, 64, 64, 1, 0.1, "single"),
                           rand_keep(1, 2, 64, 64, 2, 0.1, "single"))
    # a negative seed folds through 31 bits, as JAX's does
    assert torch.equal(rand_keep(1, 2, 64, 64, -5, 0.1, "single"),
                       rand_keep(1, 2, 64, 64, -5 & 0x7FFFFFFF, 0.1,
                                 "single"))
    with pytest.raises(ValueError, match="requires dropout_seed"):
        flash_attention_e(qkv, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attention_e(qkv, dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_e(qkv, dropout_rate=0.1, dropout_seed=2 ** 31)
    g = torch.Generator().manual_seed(0)
    seeds = [dropout_seed(g) for _ in range(4)]
    assert all(isinstance(x, int) and 0 <= x < 2 ** 31 - 1 for x in seeds)
    assert len(set(seeds)) == 4
