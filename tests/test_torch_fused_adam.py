"""Port parity: the Adam pipeline sweep
(``apex_tpu_torch.ops.adam_pipeline``) against the JAX package's
``adam_pipeline(use_pallas=True)`` (its Pallas ``_adam_pipeline_kernel``
through ``_elementwise_call`` in CPU interpret mode), and
``FusedAdam.pipeline_step`` against the JAX ``fused_adam`` pipeline
step, on the same numpy inputs.

Tolerances: masters and moments 1e-6 relative plus 1e-7 absolute (the
same fp32 expression; the two compilers may contract a multiply-add
differently, and b1*m + (1-b1)*g can cancel to far below its O(1)
operands, whose fp32 ulp is ~1e-7);
the bf16 model copy within one bf16 ulp of the JAX one (it is the cast
of masters that agree to 1e-6, so a value on a rounding boundary may
round the other way).  A skipped step (finite/keep False) is bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops.fused_pipeline import adam_pipeline as jax_adam_pipeline
from apex_tpu.ops.fused_pipeline import pack_grads, pack_masters
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch.ops import adam_pipeline
from apex_tpu_torch.optimizers import fused_adam

N = 128 * 40
RTOL = 1e-6
ATOL = 1e-7


def _buffers(seed, n=N):
    rng = np.random.RandomState(seed)
    g = (rng.randn(n) * 3).astype(np.float32)
    p = rng.randn(n).astype(np.float32)
    m = (rng.randn(n) * 0.1).astype(np.float32)
    v = np.abs(rng.randn(n) * 0.01).astype(np.float32)
    return g, p, m, v


def _bf16_ulp_close(got, want):
    """|got - want| <= one bf16 ulp of want (2^-7 relative)."""
    want = np.asarray(want, np.float32)
    ulp = np.maximum(np.abs(want), 1e-30) * 2.0 ** -7
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= ulp)


HYP = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
           bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3)


@pytest.mark.parametrize("finite", [True, False])
@pytest.mark.parametrize("adam_w_mode,wd", [(True, 0.01), (False, 0.02)])
def test_sweep_matches_jax_pallas(finite, adam_w_mode, wd):
    g, p, m, v = _buffers(1)
    gj = jnp.asarray(g).astype(jnp.bfloat16)
    want = jax_adam_pipeline(gj, jnp.asarray(p), jnp.asarray(m),
                             jnp.asarray(v), grad_scale=0.5,
                             weight_decay=wd, adam_w_mode=adam_w_mode,
                             finite=finite, lowp_dtype=jnp.bfloat16,
                             use_pallas=True, **HYP)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).bfloat16()
    pt, mt, vt = (torch.from_numpy(a.copy()) for a in (p, m, v))
    lowp = torch.empty(N, dtype=torch.bfloat16)
    adam_pipeline(gt, pt, mt, vt, lowp, grad_scale=0.5, weight_decay=wd,
                  adam_w_mode=adam_w_mode, keep=finite, **HYP)
    for got, w, old in zip((pt, mt, vt), want[:3], (p, m, v)):
        if finite:
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)
        else:                             # skipped: bitwise unchanged
            assert np.array_equal(got.numpy(), old)
            assert np.array_equal(np.asarray(w), old)
    _bf16_ulp_close(lowp.float().numpy(), want[3].astype(jnp.float32))


def test_pipeline_step_count_and_skip_match_jax():
    # three steps, the middle one skipped: bias corrections at count + 1
    # and the count holding still on the skip, as the JAX pipeline_step
    n = 3000
    _, p, _, _ = _buffers(2, n)
    grads = [(np.random.RandomState(10 + i).randn(n) * 0.1)
             .astype(np.float32) for i in range(3)]
    tree = {"w": jnp.asarray(p)}
    model_tree = {"w": jnp.asarray(p).astype(jnp.bfloat16)}
    masters = pack_masters(tree, model_tree)
    tx = jax_fused_adam(1e-2, weight_decay=0.01, use_pallas=True)
    state = tx.pipeline_init(masters.metas)
    bufs = masters.bufs
    ours = fused_adam(1e-2, weight_decay=0.01)
    pt = torch.from_numpy(p.copy())
    ostate = ours.pipeline_init([pt])
    lowp = torch.empty(n, dtype=torch.bfloat16)
    for g, finite in zip(grads, (True, False, True)):
        gj = {"w": jnp.asarray(g).astype(jnp.bfloat16)}
        bufs, state, lowps = tx.pipeline_step(
            pack_grads(gj, masters.metas), state, bufs, masters.metas,
            grad_scale=1.0, finite=finite)
        gt = torch.from_numpy(np.array(gj["w"].astype(jnp.float32)))
        ostate = ours.pipeline_step([gt.bfloat16()], ostate, [pt], [lowp],
                                    grad_scale=1.0, finite=finite)
    assert ostate.count == int(state.count) == 2
    np.testing.assert_allclose(pt.numpy(), np.asarray(bufs[0])[:n],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ostate.m[0].numpy(),
                               np.asarray(state.m[0])[:n], rtol=RTOL,
                               atol=ATOL)
    _bf16_ulp_close(lowp.float().numpy(),
                    np.asarray(lowps[0].astype(jnp.float32))[:n])


def test_max_grad_norm_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="max_grad_norm"):
        fused_adam(1e-3, max_grad_norm=1.0)
