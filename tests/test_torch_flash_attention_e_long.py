"""Port parity for rows 11 and 13: ``apex_tpu_torch.ops.flash_attention_e``
forward and gradients at a sequence whose 128-padded length is past
1024, where the JAX package's ``flash_attention_e`` takes its blocked
walk (``_flash_fwd_e_blocked``, ``_flash_bwd_e_blocked``: (512, 512)
tiles, online softmax, Pallas in CPU interpret mode), on the same numpy
inputs, fp32, HIGHEST matmul precision.  The port runs the same kernels
at every length and counts them as ``flash_attention_e_blocked`` /
``flash_attention_e_bwd_blocked`` there; on the CPU the plain versions
run.

Cases: (b, s, h, d) = (1, 1152, 2, 64), JAX's own default-tier blocked
shape (``tests/test_flash_attention.py``), causal and full; a (2, s)
kv_mask on the blocked route (row 0 full, row 1 padded past a seeded
length); and d = 128 on the single-block route at s = 128 causal and s
= 64 full (the port's E kernels at its second head dim).

Tolerances (``tests/test_torch_flash_attention_e.py``'s): o 2e-5, dqkv
1e-4 (measured at most 2.7e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.flash_attention import _e_mode
from apex_tpu.ops.flash_attention import \
    flash_attention_e as jax_flash_attention_e
from apex_tpu_torch.ops import e_mode, flash_attention_e
from apex_tpu_torch.ops.flash_attention import _e_counter

O_TOL = 2e-5
GRAD_TOL = 1e-4


def _run(b, s, h, d, causal, mask, seed):
    rng = np.random.RandomState(seed)
    qkv = (0.5 * rng.randn(b, s, h, 3 * d)).astype(np.float32)
    do = rng.randn(b, s, h * d).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    with jax.default_matmul_precision("highest"):
        o_j, vjp = jax.vjp(lambda t: jax_flash_attention_e(
            t, scale=d ** -0.5, causal=causal, kv_mask=jm), jnp.asarray(qkv))
        dqkv_j, = vjp(jnp.asarray(do))
    qt = torch.from_numpy(qkv).requires_grad_(True)
    o_t = flash_attention_e(qt, causal=causal, kv_mask=None if mask is None
                            else torch.from_numpy(mask))
    o_t.backward(torch.from_numpy(do))
    assert o_t.shape == (b, s, h * d) and qt.grad.shape == qkv.shape
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=O_TOL, atol=O_TOL)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(dqkv_j),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    return qt.grad


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_route_matches_jax(causal):
    b, s, h, d = 1, 1152, 2, 64
    assert _e_mode(s, h, d)[0] == "blocked"
    assert e_mode(s) == "blocked"
    assert _e_counter(s, None) == "flash_attention_e_blocked"
    assert _e_counter(s, None, bwd=True) == "flash_attention_e_bwd_blocked"
    _run(b, s, h, d, causal, None, seed=11 + causal)


def test_blocked_route_kv_mask_matches_jax():
    b, s, h, d = 2, 1152, 2, 64
    assert _e_mode(s, h, d)[0] == "blocked"
    mask = np.ones((b, s), np.float32)
    mask[1, np.random.RandomState(3).randint(600, 1100):] = 0.0
    dqkv = _run(b, s, h, d, True, mask, seed=13)
    # a masked key takes no gradient in k or v
    assert float(dqkv[1][mask[1] == 0][..., d:].abs().max()) == 0.0
    # the masked lane counts under its own name at any length
    assert _e_counter(s, torch.from_numpy(mask)) == "flash_attention_e_kvmask"


@pytest.mark.parametrize("s,causal", [(128, True), (64, False)])
def test_head_dim_128_matches_jax(s, causal):
    assert e_mode(s) == "single" and _e_mode(s, 2, 128)[0] == "single"
    _run(2, s, 2, 128, causal, None, seed=s)
