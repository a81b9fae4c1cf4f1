"""The numerics contract of the flash forward (rows 6, 7, 10, 11 and the
partial's): why the tensor-core kernel (``csrc/flash_fwd.cuh``
``mma_fwd_kernel``) feeds the unnormalized p to its P V product as
terms that carry its fp32 value (``flash_mma.cuh`` ``split_n``: each term
the rounded remainder past the ones before; three in bf16, two in fp16)
instead of rounding it to v's dtype where JAX's kernels do
(``apex_tpu/ops/flash_attention.py:400``, ``:506``, ``:1916``,
``:2048``), while its plain version, ``mha_reference``, keeps fp32 p.

At (1, 8, 1024, 64) causal, with fp32 scores and sums from float64 sums
(another order than the plain version's float32 ones, as the kernel's
are), under ``chip_smoke.py``'s element hold of a forward
(``_hold_forward``: one bf16 ulp of the reference plus 1e-5):

1. A hi + lo split holds against ``mha_reference`` (measured 5.2e-7
   beyond the ulp in bf16, 1.2e-7 in fp16).
2. Two evaluations that both round p at JAX's point, one with float32
   sums and one with float64, miss that hold (1.7e-4 in bf16, 2.5e-5 in
   fp16): fp32 noise carries a p across a rounding boundary, and the
   flip moves its row's o by an operand ulp of p times v over l, past the
   hold where the row's sum cancels.
3. In bf16 two terms carry 16 of p's 24 bits, and o's final rounding
   then differs from the plain version's on 1150 of 524,288 elements,
   against 136 with fp32 p; three terms give the same 136.  Each such
   flip is within the element hold; the kernel takes three terms so that
   its o rounds as often as an fp32 evaluation's does.
"""
import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import mha_reference

# chip_smoke.py's element hold of a forward against its plain version:
# |got - ref| <= O_ULP_RTOL |ref| + O_ATOL
O_ULP_RTOL = 2.0 ** -7
O_ATOL = 1e-5
DTYPES = (torch.bfloat16, torch.float16)


def _inputs(b, h, s, d, dtype, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
            .to(dtype) for _ in "qkv"]


def _split(x, dtype):
    """The kernel's two-term operand: hi = round(x), lo = round(x - hi),
    the product reading hi + lo."""
    hi = x.to(dtype).float()
    return hi + (x - hi).to(dtype).float()


def _split3(x, dtype):
    """The kernel's bf16 operand: three terms, each the rounded remainder
    past the ones before, carrying all of fp32's 24 significand bits."""
    hi = x.to(dtype).float()
    mid = (x - hi).to(dtype).float()
    return hi + mid + (x - hi - mid).to(dtype).float()


def _exact(x, dtype):
    """p as the plain version reads it: fp32."""
    return x


def _jax_rounded(x, dtype):
    """JAX's operand: x rounded once to v's dtype."""
    return x.to(dtype).float()


def _forward(q, k, v, operand, order):
    """The causal forward with fp32 scores, p and l from sums taken in
    ``order`` (float32 or float64), the unnormalized p entering P V as
    ``operand(p, dtype)`` and o = (P V) / l rounded once."""
    scale = q.shape[-1] ** -0.5
    s = (torch.einsum("bhqd,bhkd->bhqk", q.to(order), k.to(order))
         * scale).float()
    n = s.shape[-1]
    s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                      -float("inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.to(order).sum(-1, keepdim=True).float()
    acc = torch.einsum("bhqk,bhkd->bhqd", operand(p, v.dtype).to(order),
                       v.to(order)).float()
    return (acc / l).to(q.dtype)


def _hold_excess(got, want):
    """chip_smoke.py's ``grad_excess``: max of |got - ref| beyond one
    bf16 ulp of the reference."""
    return float(((got.float() - want.float()).abs()
                  - O_ULP_RTOL * want.float().abs()).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_p_holds_rounded_p_does_not(dtype):
    q, k, v = _inputs(1, 8, 1024, 64, dtype, seed=1)
    plain = mha_reference(q, k, v, causal=True)
    split = _forward(q, k, v, _split, torch.float64)
    assert _hold_excess(split, plain) <= O_ATOL
    # both versions rounding p at JAX's point: the rounding flips alone
    # put elements past the hold
    rounded = [_forward(q, k, v, _jax_rounded, order)
               for order in (torch.float64, torch.float32)]
    assert _hold_excess(*rounded) > O_ATOL


def test_three_bf16_terms_round_o_as_fp32_p_does():
    # two bf16 terms carry 16 of p's 24 bits: o's final rounding flips
    # against the plain version several times as often as with fp32 p;
    # three terms carry all 24
    q, k, v = _inputs(1, 8, 1024, 64, torch.bfloat16, seed=1)
    plain = mha_reference(q, k, v, causal=True).float()
    flips = {name: int((_forward(q, k, v, op, torch.float64).float()
                        != plain).sum())
             for name, op in (("fp32", _exact), ("two", _split),
                              ("three", _split3))}
    assert flips["three"] <= flips["fp32"]
    assert flips["two"] > 4 * flips["fp32"]
