"""Port parity for the int8 KV cache: the int8 branches of
``apex_tpu_torch.ops.flash_decode`` / ``flash_decode_multi`` (their
plain versions, which a CPU tensor runs) against the JAX package's
Pallas kernels in CPU interpret mode, and the port's int8 cache writes
against ``apex_tpu.serving``'s.

The JAX cache stores d=64 head pairs packed as (nb, h/2, bs, 2d); the
port stores (nb, h, bs, d).  Each case quantizes one dense cache per row
(``quantize_kv_rows``), hands JAX the packed codes and the port the dense
ones, and both the same (nb, h, bs) scales (global head order in both
layouts).  The hard rows are baked in: an inactive row and front-padding
rows (exactly 0 out), a row straddling a page, a row filling every page,
dump-page padding.

Tolerances: attention 1e-5 (fp32 online softmax page by page against the
port's dense fp32 softmax over the same dequantized values); cache
codes and scales exact (the same quantizer); a written row read back
within 5e-2 of what was written (JAX's int8 readback tolerance).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_decode import dequantize_kv as jax_dequantize_kv
from apex_tpu.ops.flash_decode import flash_decode as jax_decode
from apex_tpu.ops.flash_decode import flash_decode_multi as jax_decode_multi
from apex_tpu.ops.flash_decode import pack_decode_heads
from apex_tpu.serving import KVCacheConfig as JaxCacheConfig
from apex_tpu.serving import init_cache as jax_init_cache
from apex_tpu.serving import write_prefill_kv as jax_write_prefill
from apex_tpu.serving import write_token_kv as jax_write_token
from apex_tpu_torch.ops import (dequantize_kv, flash_decode,
                                flash_decode_multi,
                                paged_attention_multi_reference)
from apex_tpu_torch.serving import (KVCacheConfig, copy_cache_block,
                                    init_cache, quantize_kv_rows,
                                    write_prefill_kv, write_token_kv)

TOL = 1e-5
READBACK_TOL = 5e-2


def _case(b=4, h=2, d=64, nb=12, bs=4, mp=3, t=1, seed=0):
    """int8 codes (nb, h, bs, d) and (nb, h, bs) scales for k and v,
    q (b, t, h, d), tables and lengths; row 0 inactive, row 1 straddling
    a page, row 2 filling every page, row 3 shorter than t."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    kq, ks = quantize_kv_rows(torch.from_numpy(
        rng.randn(nb, h, bs, d).astype(np.float32) * 2.0))
    vq, vs = quantize_kv_rows(torch.from_numpy(
        rng.randn(nb, h, bs, d).astype(np.float32)))
    lens = [0, mp * bs - bs // 2 - 1, mp * bs, max(1, t - 1)][:b]
    bt = np.zeros((b, mp), np.int32)
    pool = rng.permutation(np.arange(1, nb))
    nxt = 0
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        bt[i, :pages] = pool[nxt:nxt + pages]
        nxt += pages
    return (q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy(), bt,
            np.asarray(lens, np.int32))


def _packed(dense):
    return np.array(pack_decode_heads(
        jnp.asarray(dense).transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3))


def _unpack_cache(x, h):
    """JAX's (L, nb, h/2, bs, 2d) packed cache -> (L, nb, h, bs, d)."""
    L, nb, hp, bs, d2 = x.shape
    return x.transpose(0, 1, 3, 2, 4).reshape(L, nb, bs, h, d2 // 2) \
        .transpose(0, 1, 3, 2, 4)


@pytest.mark.parametrize("bs", [4, 16])
def test_decode_int8_matches_jax_packed(bs):
    q, kq, vq, ks, vs, bt, sl = _case(bs=bs, seed=bs)
    q = q[:, 0]
    assert _packed(kq).shape == (12, 1, bs, 128) and _packed(kq).dtype \
        == np.int8
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_decode(
            *map(jnp.asarray, (q, _packed(kq), _packed(vq), bt, sl)),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = flash_decode(*map(torch.from_numpy, (q, kq, vq, bt, sl)),
                       k_scale=torch.from_numpy(ks),
                       v_scale=torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[0] == 0).all()                  # seq_len 0: exact zeros


@pytest.mark.parametrize("t", [3, 6])
def test_decode_multi_int8_matches_jax_packed(t):
    q, kq, vq, ks, vs, bt, sl = _case(t=t, bs=4, seed=20 + t)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_decode_multi(
            *map(jnp.asarray, (q, _packed(kq), _packed(vq), bt, sl)),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = flash_decode_multi(*map(torch.from_numpy, (q, kq, vq, bt, sl)),
                             k_scale=torch.from_numpy(ks),
                             v_scale=torch.from_numpy(vs)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    qpos = sl[:, None] - t + np.arange(t)[None, :]
    assert (got[qpos < 0] == 0).all() and (qpos < 0).sum() >= t + 1


def test_bf16_q_over_int8_cache_matches_the_dequantized_float_cache():
    # the int8 branch reads code * scale in fp32: the same attention as a
    # float cache holding those fp32 values
    q, kq, vq, ks, vs, bt, sl = _case(t=3, seed=7)
    args = [torch.from_numpy(a) for a in (kq, vq, ks, vs)]
    qb = torch.from_numpy(q).bfloat16()
    kf, vf = dequantize_kv(args[0], args[2]), dequantize_kv(args[1], args[3])
    bt_t, sl_t = torch.from_numpy(bt), torch.from_numpy(sl)
    got = flash_decode_multi(qb, args[0], args[1], bt_t, sl_t,
                             k_scale=args[2], v_scale=args[3])
    want = paged_attention_multi_reference(qb, kf, vf, bt_t, sl_t)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_dequantize_kv_matches_jax():
    _, kq, _, ks, _, _, _ = _case(seed=3)
    want = np.asarray(jax_dequantize_kv(jnp.asarray(kq), jnp.asarray(ks)))
    got = dequantize_kv(torch.from_numpy(kq), torch.from_numpy(ks)).numpy()
    np.testing.assert_array_equal(got, want)
    k = torch.randn(2, 2, 4, 8)
    assert dequantize_kv(k, None) is k


def test_scale_arguments_checked():
    q, kq, vq, ks, vs, bt, sl = map(torch.from_numpy, _case(seed=4))
    q = q[:, 0]
    with pytest.raises(ValueError, match="both"):
        flash_decode(q, kq, vq, bt, sl, k_scale=ks)
    with pytest.raises(TypeError, match="int8 cache"):
        flash_decode(q, kq, vq, bt, sl)
    with pytest.raises(TypeError, match="int8 cache"):
        flash_decode(q, kq.float(), vq.float(), bt, sl, k_scale=ks,
                     v_scale=vs)
    with pytest.raises(ValueError, match="global head order"):
        flash_decode_multi(q[:, None], kq, vq, bt, sl,
                           k_scale=ks[:, :, :2], v_scale=vs[:, :, :2])


def _configs(num_blocks=8, block_size=4, h=2, d=64, kv_dtype="int8"):
    jcfg = JaxCacheConfig(num_layers=2, num_heads=h, head_dim=d,
                          num_blocks=num_blocks, block_size=block_size,
                          kv_dtype=kv_dtype, model_dtype=jnp.float32)
    tcfg = KVCacheConfig(num_layers=2, num_heads=h, head_dim=d,
                         num_blocks=num_blocks, block_size=block_size,
                         kv_dtype=kv_dtype)
    return jcfg, tcfg


@pytest.mark.parametrize("kv_dtype", ["model", "bf16", "int8"])
def test_cache_config_matches_jax(kv_dtype):
    jcfg, tcfg = _configs(kv_dtype=kv_dtype)
    assert tcfg.quantized == jcfg.quantized
    assert tcfg.scale_shape == jcfg.scale_shape
    assert tcfg.cache_nbytes() == jcfg.cache_nbytes()
    assert str(tcfg.storage_dtype).replace("torch.", "") \
        == np.dtype(jcfg.storage_dtype).name
    cache = init_cache(tcfg, "cpu")
    assert cache.k.dtype == tcfg.storage_dtype
    if tcfg.quantized:
        assert cache.k_scale.shape == tcfg.scale_shape
        assert cache.k_scale.data_ptr() != cache.v_scale.data_ptr()
    else:
        assert cache.k_scale is None and cache.layer(1)[2] is None
    with pytest.raises(ValueError, match="kv_dtype"):
        KVCacheConfig(num_layers=1, num_heads=2, head_dim=8, num_blocks=4,
                      block_size=4, kv_dtype="fp8")


def test_int8_writes_equal_jax_and_read_back():
    jcfg, tcfg = _configs()
    rng = np.random.RandomState(5)
    k_all = rng.randn(8, 2, 64).astype(np.float32) * 3.0     # 2 pages
    v_all = rng.randn(8, 2, 64).astype(np.float32)
    k_tok = rng.randn(2, 2, 64).astype(np.float32)
    blocks, wb, wo = [3, 5], [6, 2], [1, 3]
    jc = jax_write_prefill(jax_init_cache(jcfg), jcfg, 1,
                           jnp.asarray(k_all), jnp.asarray(v_all),
                           jnp.asarray(blocks, jnp.int32))
    jc = jax_write_token(jc, jcfg, 0, jnp.asarray(k_tok),
                         jnp.asarray(k_tok * 2), jnp.asarray(wb, jnp.int32),
                         jnp.asarray(wo, jnp.int32))
    tc = init_cache(tcfg, "cpu")
    write_prefill_kv(tc, tcfg, 1, torch.from_numpy(k_all),
                     torch.from_numpy(v_all), torch.tensor(blocks))
    write_token_kv(tc, tcfg, 0, torch.from_numpy(k_tok),
                   torch.from_numpy(k_tok * 2), torch.tensor(wb),
                   torch.tensor(wo))
    assert tc.k.dtype == torch.int8
    for jx, tx in ((jc.k, tc.k), (jc.v, tc.v)):
        np.testing.assert_array_equal(tx.numpy(),
                                      _unpack_cache(np.asarray(jx), 2))
    for jx, tx in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    # read back: prefill rows (page p, slot s) and the token rows
    kd = dequantize_kv(tc.k[1], tc.k_scale[1])
    got = kd[torch.tensor(blocks)].transpose(1, 2).reshape(8, 2, 64)
    np.testing.assert_allclose(got.numpy(), k_all, rtol=READBACK_TOL,
                               atol=READBACK_TOL)
    vd = dequantize_kv(tc.v[0], tc.v_scale[0])
    for i in range(2):
        np.testing.assert_allclose(vd[wb[i], :, wo[i]].numpy(),
                                   k_tok[i] * 2, rtol=READBACK_TOL,
                                   atol=READBACK_TOL)


def test_copy_cache_block_carries_scales():
    _, tcfg = _configs()
    tc = init_cache(tcfg, "cpu")
    x = torch.randn(8, 2, 64)
    write_prefill_kv(tc, tcfg, 0, x, -x, torch.tensor([2, 4]))
    write_prefill_kv(tc, tcfg, 1, 2 * x, x, torch.tensor([2, 4]))
    copy_cache_block(tc, 4, 6)
    for a in (tc.k, tc.v, tc.k_scale, tc.v_scale):
        assert torch.equal(a[:, 6], a[:, 4]) and bool((a[:, 4] != 0).any())
