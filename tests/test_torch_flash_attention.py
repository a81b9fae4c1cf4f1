"""Port parity: ``apex_tpu_torch.ops.flash_attention`` against the JAX
package's ``flash_attention`` / ``flash_attention_partial`` (the Pallas
``_flash_fwd`` in CPU interpret mode, head-packed at d=64 with even h),
on the same numpy inputs, fp32, with the JAX side's matmuls at HIGHEST
precision (DEFAULT truncates fp32 operands to bf16 on the CPU too).

Tolerance 1e-5: fp32 online softmax against the port's materialized
fp32 softmax, the same operations summed in another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import (flash_attention_partial,
                                          flash_attention as jax_flash)
from apex_tpu_torch.ops import (flash_attention, flash_attention_with_lse,
                                mha_reference)

TOL = 1e-5


def _qkv(b, h, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32)
            for s in (sq, sk, sk)]


# s=200 is not a multiple of any tile; s=640 pads past the JAX single-
# block limit (512) into its gridded kernel; d=64 with h=2 is packed
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 200, 640])
def test_matches_jax(causal, s):
    q, k, v = _qkv(1, 2, s, s, 64, seed=s)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                    causal=causal))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_lse_matches_jax_partial():
    q, k, v = _qkv(2, 2, 96, 96, 64, seed=7)
    with jax.default_matmul_precision("highest"):
        o_j, lse_j = flash_attention_partial(*map(jnp.asarray, (q, k, v)),
                                             causal=True)
    o, lse = flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)),
                                      causal=True)
    assert lse.shape == (2, 2, 96) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_j).reshape(2, 2, 96),
                               rtol=TOL, atol=TOL)


def test_cross_attention_and_scale():
    q, k, v = _qkv(2, 2, 48, 160, 64, seed=3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                    scale=0.3))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          scale=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 33, 33, 64, seed=1))
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       mha_reference(q, k, v, causal=True))
