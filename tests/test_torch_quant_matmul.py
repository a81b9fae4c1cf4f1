"""Port parity for the Q8 tier's quantizers and weight matmul:
``apex_tpu_torch.ops.quant_matmul`` and the port's ``quantize_kv_rows``
against ``apex_tpu`` on the same numpy inputs.

* The quantizers (``quantize_weight`` per output column,
  ``quantize_kv_rows`` per cached row) must give codes and scales
  bitwise equal to JAX's: both divide in fp32 and round half to even.
  The inputs include a bf16-cast weight, a column whose amax sits on
  exact multiples of its scale (so codes hit +-127 and round-half ties),
  and an all-zero column or row (the 1e-8 scale floor: codes 0, exact 0
  back).
* The plain ``quant_matmul`` (what a CPU tensor runs) against JAX's
  ``quant_matmul(backend="pallas")``, the Pallas GEMV and tiled kernels
  in CPU interpret mode, at JAX's ``self_check`` shapes and with leading
  dimensions and an out dtype.  Tolerances: fp32 out 1e-5 (the
  ``self_check`` rtol/atol: the same fp32 products summed in another
  order); a bf16 out one bf16 ulp (2^-7 relative) plus 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.quant_matmul import quant_matmul as jax_qmm
from apex_tpu.ops.quant_matmul import quantize_weight as jax_quantize
from apex_tpu.ops.quant_matmul import quantize_weights as jax_quantize_tree
from apex_tpu.serving import extract_serving_weights
from apex_tpu.serving.kv_cache import quantize_kv_rows as jax_kv_rows
from apex_tpu.testing.standalone_gpt import GPTModel
from apex_tpu_torch.ops import (dequantize_weight, is_quantized_weights,
                                quant_matmul, quant_matmul_reference,
                                quantize_weight, quantize_weights)
from apex_tpu_torch.serving import (ServingModelConfig, quantize_kv_rows,
                                    serving_weights_from_numpy)

TOL = 1e-5
BF16_REL = 2.0 ** -7
SELF_CHECK_SHAPES = ((1, 96, 160), (4, 128, 384), (8, 256, 256),
                     (160, 128, 256))


def _weight(k, n, seed):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32) * 0.02
    # column 0: amax 1.27 with entries on multiples of 0.005 = its scale,
    # so codes reach +-127 and hit round-half ties; column 1: all zero
    w[:, 0] = np.linspace(-1.27, 1.27, k).round(3).astype(np.float32)
    w[0, 0] = 1.27
    w[:, 1] = 0.0
    return w


@pytest.mark.parametrize("k,n,seed", [(64, 96, 0), (512, 768, 1)])
def test_quantize_weight_bitwise_equals_jax_on_bf16_weight(k, n, seed):
    w = _weight(k, n, seed)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jw.astype(jnp.float32)),
                          tw.float().numpy())
    jq, js = jax_quantize(jw)
    tq, ts = quantize_weight(tw)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.abs(tq[:, 0].numpy()).max() == 127
    assert (tq[:, 1] == 0).all() and ts[1] == np.float32(1e-8) / 127
    assert (dequantize_weight(tq, ts)[:, 1] == 0).all()


def test_quantize_weight_bitwise_equals_jax_fp32():
    w = _weight(96, 160, 2) * 50.0
    jq, js = jax_quantize(jnp.asarray(w))
    tq, ts = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_kv_rows_bitwise_equals_jax():
    x = np.random.RandomState(3).randn(37, 4, 64).astype(np.float32) * 3.0
    x[5, 1] = 0.0                                  # an all-zero row
    x[6, 2] = np.arange(64, dtype=np.float32) - 32.0   # ties at +-0.5
    for arr in (x, np.array(jnp.asarray(x).astype(jnp.bfloat16)
                            .astype(jnp.float32))):
        jq, js = jax_kv_rows(jnp.asarray(arr))
        tq, ts = quantize_kv_rows(torch.from_numpy(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert (tq[5, 1] == 0).all()


@pytest.mark.parametrize("m,k,n", SELF_CHECK_SHAPES)
def test_plain_matches_jax_pallas_kernels(m, k, n):
    # M <= 8 is JAX's GEMV kernel, more its tiled kernel
    w = _weight(k, n, m)
    x = np.random.RandomState(10 + m).randn(m, k).astype(np.float32)
    jq, js = jax_quantize(jnp.asarray(w))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_qmm(jnp.asarray(x), jq, js, backend="pallas"))
    tq, ts = quantize_weight(torch.from_numpy(w))
    got = quant_matmul(torch.from_numpy(x), tq, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got[:, 1] == 0).all()                  # the all-zero column


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_leading_dims_and_out_dtype_match_jax(out_dtype):
    w = _weight(128, 384, 7)
    x = np.random.RandomState(8).randn(2, 5, 128).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)       # bf16 activations
    jq, js = jax_quantize(jnp.asarray(w))
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_qmm(xb, jq, js, out_dtype=jdt,
                                  backend="pallas").astype(jnp.float32))
    tq, ts = quantize_weight(torch.from_numpy(w))
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = quant_matmul(tx, tq, ts, out_dtype=out_dtype)
    assert got.shape == (2, 5, 384) and got.dtype == out_dtype
    rtol = TOL if out_dtype == torch.float32 else BF16_REL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=TOL)


def test_cpu_wrapper_is_the_plain_version_and_checks_inputs():
    tq, ts = quantize_weight(torch.from_numpy(_weight(32, 48, 4)))
    x = torch.randn(3, 32)
    assert torch.equal(quant_matmul(x, tq, ts),
                       quant_matmul_reference(x, tq, ts))
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x, tq.float(), ts)
    with pytest.raises(ValueError, match="contraction"):
        quant_matmul(torch.randn(3, 31), tq, ts)
    with pytest.raises(ValueError, match="mismatch"):
        quant_matmul(x, tq, ts[:-1])


def test_quantize_weights_tree_equals_jax():
    model = GPTModel(vocab_size=64, hidden_size=64, num_layers=2,
                     num_attention_heads=2, max_sequence_length=32,
                     attention_dropout=0.0, hidden_dropout=0.0,
                     use_flash=False, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jw = extract_serving_weights(params, 2)
    cfg = ServingModelConfig(vocab_size=64, hidden_size=64, num_heads=2,
                             num_layers=2, max_seq=32)
    tw = serving_weights_from_numpy(jax.tree.map(np.asarray, jw), cfg,
                                    device="cpu")
    tq8 = quantize_weights(tw)
    jq8 = jax.tree.map(np.asarray, jax_quantize_tree(jw))
    assert is_quantized_weights(tq8) and not is_quantized_weights(tw)
    for tl, jl in zip(tq8.layers, jq8.layers):
        for name in ("qkv", "dense", "fc1", "fc2"):
            np.testing.assert_array_equal(getattr(tl, f"{name}_k").numpy(),
                                          getattr(jl, f"{name}_k"))
            np.testing.assert_array_equal(getattr(tl, f"{name}_s").numpy(),
                                          getattr(jl, f"{name}_s"))
    # the JAX Q8 tree carried across keeps its codes and scales
    carried = serving_weights_from_numpy(jq8, cfg, device="cpu")
    assert is_quantized_weights(carried)
    for tl, cl in zip(tq8.layers, carried.layers):
        assert cl.qkv_k.dtype == torch.int8
        assert torch.equal(tl.fc2_k, cl.fc2_k)
        assert torch.equal(tl.fc2_s, cl.fc2_s)
