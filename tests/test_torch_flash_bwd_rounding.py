"""The numerics contract of the flash backward (rows 8, 9, 12, 13 and the
partial's): what ``flash_attention_backward_reference``, the plain
version every backward kernel is held against on the card, computes, and
why the tensor-core kernel feeds p and ds to its products as hi + lo
pairs instead of rounding them where JAX's kernels do.

1. In fp32 the plain backward equals, bit for bit, its formula written
   out here.
2. In bf16 and fp16 it equals the same formula with p and ds kept in
   fp32 (the operands upcast, each gradient rounded once): causal and
   full, sq != sk, the kv_mask, the offsets with an lse cotangent, and
   the dropout keep.
3. The E, packed-qkv and partial references give (2) on their views.
4. The kernel's split (``flash_bwd.cuh`` ``split2``: hi = round(x), lo =
   round(x - hi)) holds against the plain version under the card's
   element hold (``chip_smoke.py``'s one bf16 ulp of the reference plus
   1e-5), evaluated with fp32 values from float64 sums, another order
   than the plain version's (measured at (1, 8, 1024, 64) causal: 8.6e-7
   beyond the ulp in bf16, 1.8e-6 in fp16).  Rounding p and ds at JAX's
   points (``apex_tpu/ops/flash_attention.py:924``, ``:925``, ``:844``
   and the E kernels' ``:2196``, ``:2203-2204``) in both versions
   misses that hold (2.0e-4 in bf16, 6.0e-5 in fp16): a value carried
   across a rounding boundary by fp32 noise moves a gradient element by
   an operand ulp times its partner.
5. Against ``jax.vjp`` of the JAX package's ``flash_attention`` in bf16
   (Pallas in interpret mode, d = 64, where JAX's v-dtype scale 1/8 is
   exact), the plain backward stays within ``JAX_BF16_TOL`` of each
   gradient's largest value: JAX rounds p and ds to bf16, the port does
   not (measured at most 5.3e-3).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import flash_attention as jax_flash
from apex_tpu_torch.ops import flash_attention as port_flash
from apex_tpu_torch.ops import (flash_attention_backward_reference,
                                flash_attention_e_backward_reference,
                                flash_attention_partial_reference,
                                flash_attention_qkv, mha_reference,
                                rand_keep)

# chip_smoke.py's element hold of a backward kernel against this plain
# version: |got - ref| <= DQKV_ULP_RTOL |ref| + DQKV_ATOL
DQKV_ULP_RTOL = 2.0 ** -7
DQKV_ATOL = 1e-5
# the plain bf16 backward against JAX's, relative to max |gradient|
JAX_BF16_TOL = 1e-2
DTYPES = (torch.bfloat16, torch.float16)


def _inputs(b, h, sq, sk, d, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(dtype) for s in (sq, sk, sk))
    do = torch.from_numpy(rng.randn(b, h, sq, d).astype(np.float32)) \
        .to(dtype)
    return q, k, v, do


def _formula(q, k, v, o, lse, do, scale, keep=None, rate=0.0, drop=None,
             dlse=None):
    """The backward in fp32, written out: p from lse, masked by ``keep``
    (bool, broadcast to (b, h, sq, sk)) before it is read, dv from the
    dropped p, ds = p (dp - delta) scale with dp dropped alike, each
    gradient rounded once to its operand's dtype."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
                  - lse.unsqueeze(-1))
    if keep is not None:
        p = torch.where(keep, p, torch.zeros(()))
    delta = (dof * of).sum(-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float().unsqueeze(-1)
    dropped = (lambda x: x) if drop is None else \
        (lambda x: torch.where(drop, x * (1.0 / (1.0 - rate)), 0.0))
    dv = torch.einsum("bhqk,bhqd->bhkd", dropped(p), dof)
    dp = dropped(torch.einsum("bhqd,bhkd->bhqk", dof, vf))
    ds = p * (dp - delta) * scale
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype),
            torch.einsum("bhqk,bhqd->bhkd", ds, qf).to(k.dtype),
            dv.to(v.dtype))


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", (torch.float32,) + DTYPES)
@pytest.mark.parametrize("sq,sk,d,causal", [
    (96, 96, 64, True), (80, 112, 64, False), (112, 80, 128, True)])
def test_plain_backward_is_the_fp32_formula(dtype, sq, sk, d, causal):
    q, k, v, do = _inputs(2, 2, sq, sk, d, dtype, seed=sq + sk + d)
    o, lse = mha_reference(q, k, v, causal=causal, return_lse=True)
    keep = torch.ones(sq, sk, dtype=torch.bool).tril() if causal else None
    _assert_bitwise(flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=causal),
        _formula(q, k, v, o, lse, do, d ** -0.5, keep))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_backward_kv_mask(dtype):
    b, s, d = 3, 96, 64
    q, k, v, do = _inputs(b, 2, s, s, d, dtype, seed=3)
    kvm = torch.ones(b, s)
    kvm[0, 70:] = 0
    kvm[1] = 0          # a batch row that attends nothing
    o, lse = mha_reference(q, k, v, kv_mask=kvm, return_lse=True)
    keep = (kvm > 0)[:, None, None, :]
    got = flash_attention_backward_reference(q, k, v, o, lse, do,
                                             kv_mask=kvm)
    _assert_bitwise(got, _formula(q, k, v, o, lse, do, d ** -0.5, keep))
    assert all(not t[1].any() for t in got)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_offset,k_offset", [(40, 0), (0, 30)])
def test_plain_backward_offsets_and_lse_cotangent(dtype, q_offset,
                                                  k_offset):
    sq, sk, d = 64, 80, 64
    q, k, v, do = _inputs(1, 2, sq, sk, d, dtype, seed=q_offset + k_offset)
    o, lse = flash_attention_partial_reference(
        q, k, v, causal=True, q_offset=q_offset, k_offset=k_offset)
    dlse = torch.from_numpy(np.random.RandomState(7).randn(1, 2, sq)
                            .astype(np.float32))
    keep = torch.ones(sq, sk, dtype=torch.bool).tril(q_offset - k_offset)
    got = flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=True, q_offset=q_offset,
        k_offset=k_offset, dlse=dlse)
    _assert_bitwise(got, _formula(q, k, v, o, lse, do, d ** -0.5, keep,
                                  dlse=dlse))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_backward_dropout_keep(dtype):
    b, h, s, d, rate, seed = 1, 2, 96, 64, 0.1, 1234
    q, k, v, do = _inputs(b, h, s, s, d, dtype, seed=11)
    drop = rand_keep(b, h, s, s, seed, rate, "single")
    o, lse = mha_reference(q, k, v, causal=True, return_lse=True,
                           dropout_rate=rate, dropout_keep=drop)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    got = flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=True, dropout_rate=rate,
        dropout_keep=drop)
    _assert_bitwise(got, _formula(q, k, v, o, lse, do, d ** -0.5, keep,
                                  rate=rate, drop=drop))


@pytest.mark.parametrize("dtype", DTYPES)
def test_e_qkv_and_partial_references_are_the_formula(dtype):
    b, s, h, d = 2, 64, 2, 64
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(b, s, h, 3 * d).astype(np.float32)) \
        .to(dtype)
    do_e = torch.from_numpy(rng.randn(b, s, h * d).astype(np.float32)) \
        .to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    o, lse = mha_reference(q, k, v, causal=True, return_lse=True)
    do = do_e.reshape(b, s, h, d).transpose(1, 2)
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    want = _formula(q, k, v, o, lse, do, d ** -0.5, keep)
    # the E layout: one dqkv in qkv's lanes
    dqkv = flash_attention_e_backward_reference(
        qkv, o.transpose(1, 2), lse, do.transpose(1, 2), causal=True)
    _assert_bitwise([t.transpose(1, 2) for t in dqkv.split(d, dim=-1)],
                    want)
    # the packed (3, b, h, s, d) entry under autograd: on a CPU tensor its
    # backward is the plain version on the three views
    packed = torch.stack([q, k, v]).requires_grad_(True)
    flash_attention_qkv(packed, causal=True).backward(do)
    _assert_bitwise(packed.grad.unbind(0), want)
    # the partial at offsets where every pair is visible, with an lse
    # cotangent
    po, plse = flash_attention_partial_reference(q, k, v, causal=True,
                                                 q_offset=s, k_offset=0)
    dlse = torch.from_numpy(rng.randn(b, h, s).astype(np.float32))
    got = flash_attention_backward_reference(
        q, k, v, po, plse, do, causal=True, q_offset=s, k_offset=0,
        dlse=dlse)
    _assert_bitwise(got, _formula(q, k, v, po, plse, do, d ** -0.5,
                                  dlse=dlse))


def _split(x, dtype):
    """The kernel's two-term operand: hi = round(x), lo = round(x - hi),
    the product reading hi + lo."""
    hi = x.to(dtype).float()
    return hi + (x - hi).to(dtype).float()


def _jax_rounded(x, dtype):
    """JAX's operand: x rounded once to the operand dtype."""
    return x.to(dtype).float()


def _another_order(q, k, v, o, lse, do, scale, operand):
    """The backward with its fp32 scores, dp and delta from float64 sums
    (an order other than the plain version's float32 ones, as the
    kernel's are), p and ds entering their products as
    ``operand(x, dtype)``."""
    qd, kd, vd, od, dod = (t.double() for t in (q, k, v, o, do))
    s = (torch.einsum("bhqd,bhkd->bhqk", qd, kd) * scale).float()
    sq, sk = s.shape[-2:]
    p = torch.where(torch.ones(sq, sk, dtype=torch.bool).tril(),
                    torch.exp(s - lse.unsqueeze(-1)), torch.zeros(()))
    delta = (dod * od).sum(-1, keepdim=True).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dod, vd).float()
    ds = operand(p * (dp - delta) * scale, q.dtype)
    pv = operand(p, v.dtype)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).to(k.dtype),
            torch.einsum("bhqk,bhqd->bhkd", pv, do.float()).to(v.dtype))


def _hold_excess(got, want):
    """chip_smoke.py's ``grad_excess``: max of |got - ref| beyond one
    bf16 ulp of the reference."""
    return max(float(((g.float() - w.float()).abs()
                      - DQKV_ULP_RTOL * w.float().abs()).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_operands_hold_rounded_operands_do_not(dtype):
    q, k, v, do = _inputs(1, 8, 1024, 1024, 64, dtype, seed=1)
    o, lse = mha_reference(q, k, v, causal=True, return_lse=True)
    scale = 64 ** -0.5
    plain = flash_attention_backward_reference(q, k, v, o, lse, do,
                                               causal=True)
    split = _another_order(q, k, v, o, lse, do, scale, _split)
    assert _hold_excess(split, plain) <= DQKV_ATOL
    # both versions rounding at JAX's points: the rounding flips alone put
    # elements past the hold
    rounded = _another_order(q, k, v, o, lse, do, scale, _jax_rounded)
    assert _hold_excess(rounded, _jax_points_plain(q, k, v, o, lse, do,
                                                   scale)) > DQKV_ATOL


def _jax_points_plain(q, k, v, o, lse, do, scale):
    """The plain formula in float32 with p and ds rounded at JAX's
    points: the plain version a kernel rounding there would be held
    against."""
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = q.shape[2]
    p = torch.where(torch.ones(s, s, dtype=torch.bool).tril(),
                    torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf)
                              * scale - lse.unsqueeze(-1)), torch.zeros(()))
    delta = (dof * of).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = _jax_rounded(p * (dp - delta) * scale, q.dtype)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype),
            torch.einsum("bhqk,bhqd->bhkd", ds, qf).to(k.dtype),
            torch.einsum("bhqk,bhqd->bhkd", _jax_rounded(p, v.dtype), dof)
            .to(v.dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bf16_backward_near_jax(causal):
    b, h, s, d = 1, 2, 128, 64
    q, k, v, do = _inputs(b, h, s, s, d, torch.bfloat16, seed=21 + causal)
    as_jax = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal),
                     *as_jax[:3])
    want = vjp(as_jax[3])
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    port_flash(*ts, causal=causal).backward(do)
    for t, w in zip(ts, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        err = float((t.grad.float() - w).abs().max())
        assert math.isfinite(err)
        assert err <= JAX_BF16_TOL * float(w.abs().max())
