"""Port parity: the causal scaled softmax and its backward
(``apex_tpu_torch.ops.scaled_upper_triang_masked_softmax``) against
``apex_tpu.ops.scaled_softmax.scaled_upper_triang_masked_softmax`` (its
Pallas ``_causal_fwd`` and ``_softmax_backward`` in CPU interpret mode),
and ``FusedScaleMaskSoftmax``'s dispatch against the JAX module's.

The forward and the backward (``jax.vjp`` against the port's autograd)
take the same numpy scores at (4, 64, 64) and (3, 300, 300) (two of the
JAX kernel's 256-row blocks, the second padded), scale 0.125 and 1.0, in
fp32 and fp16; the forward is also held against a float64 softmax of
the same scores.  Tolerances: 1e-6 in fp32 (the same fp32 expression;
exp and the row sums may differ by an ulp or two of values <= 1), 1e-3
in fp16 (one fp16 ulp of a probability near 1 is 2^-11 ~ 4.9e-4).
Masked entries are exactly 0 on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.scaled_softmax import \
    scaled_upper_triang_masked_softmax as jax_causal_softmax
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional.fused_softmax import \
    FusedScaleMaskSoftmax as JaxFusedSoftmax
from apex_tpu_torch.ops import (causal_softmax_reference, launch_counts,
                                reset_launch_counts,
                                scaled_upper_triang_masked_softmax,
                                softmax_backward_reference)
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

TOL = {np.float32: 1e-6, np.float16: 1e-3}
TORCH = {np.float32: torch.float32, np.float16: torch.float16}
JAXD = {np.float32: jnp.float32, np.float16: jnp.float16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's plain versions on one CPU thread.  With JAX's CPU
    runtime in the same process, PyTorch's multi-threaded CPU kernels
    now and then returned one chunk of the softmax with a relative error
    near 1e-5 (31 rows of 256, about one run in six, never on one
    thread), which is past the fp32 tolerance this file holds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(dtype)
    dy = rng.randn(*shape).astype(dtype)
    return x, dy


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("scale", [0.125, 1.0])
@pytest.mark.parametrize("shape", [(4, 64, 64), (3, 300, 300)])
def test_forward_and_backward_match_jax(shape, scale, dtype):
    x, dy = _inputs(shape, dtype, seed=shape[1])
    jx = jnp.asarray(x, JAXD[dtype])
    y_j, vjp = jax.vjp(lambda a: jax_causal_softmax(a, scale), jx)
    dx_j, = vjp(jnp.asarray(dy, JAXD[dtype]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = scaled_upper_triang_masked_softmax(xt, scale)
    y_t.backward(torch.from_numpy(dy))
    assert y_t.dtype == TORCH[dtype] and xt.grad.dtype == TORCH[dtype]
    tol = TOL[dtype]
    # the forward against a float64 softmax of the same scores, and JAX's
    s64 = np.where(np.tril(np.ones(shape[1:], bool)),
                   x.astype(np.float64) * scale, -np.inf)
    e64 = np.exp(s64 - s64.max(-1, keepdims=True))
    np.testing.assert_allclose(y_t.detach().float().numpy(),
                               e64 / e64.sum(-1, keepdims=True), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(y_t.detach().float().numpy(),
                               np.asarray(y_j, np.float32), rtol=0, atol=tol)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dx_j, np.float32), rtol=0,
                               atol=tol)
    upper = np.triu(np.ones(shape[1:], bool), 1)
    assert (y_t.detach().numpy()[:, upper] == 0).all()
    assert (np.asarray(y_j)[:, upper] == 0).all()
    np.testing.assert_allclose(y_t.detach().float().sum(-1).numpy(), 1.0,
                               atol=10 * tol)


def test_plain_versions_are_the_kernel_math():
    # the plain versions on their own: a (2, 5, 7) block with sq < sk
    # keeps columns 0..row, and the backward sums over the whole row
    x = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(0))
    y = causal_softmax_reference(x, 0.5)
    want = torch.softmax((x * 0.5).masked_fill(
        ~torch.ones(5, 7, dtype=torch.bool).tril(), float("-inf")), -1)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-7)
    dy = torch.randn(2, 5, 7, generator=torch.Generator().manual_seed(1))
    dx = softmax_backward_reference(y, dy, 0.5)
    xg = x.clone().requires_grad_(True)
    torch.softmax((xg * 0.5).masked_fill(
        ~torch.ones(5, 7, dtype=torch.bool).tril(), -1e30), -1).backward(dy)
    torch.testing.assert_close(dx, xg.grad, rtol=0, atol=1e-6)


def _module_pair(fp16, bf16, mask_type):
    kw = dict(input_in_fp16=fp16, input_in_bf16=bf16,
              scaled_masked_softmax_fusion=True, mask_func=None,
              softmax_in_fp32=True, scale=0.125)
    return (FusedScaleMaskSoftmax(attn_mask_type=mask_type, **kw),
            JaxFusedSoftmax(attn_mask_type=JaxMaskType[mask_type.name], **kw))


def test_fp32_model_takes_the_plain_path_as_jax():
    # a model computing in fp32 is not eligible for the fused kernel (the
    # JAX is_kernel_available rule): no launch is counted, and the
    # result is JAX's forward_jax_softmax (the -10000 fill)
    scores = np.random.RandomState(3).randn(2, 2, 16, 16).astype(np.float32)
    port, ref = _module_pair(False, False, AttnMaskType.causal)
    assert not port.is_kernel_available(None, 2, 2, 16, 16)
    assert not ref.is_kernel_available(None, 2, 2, 16, 16)
    reset_launch_counts()
    got = port(torch.from_numpy(scores), None)
    assert not any(launch_counts().values())
    want = ref(jnp.asarray(scores), None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the padding type with a mask through the default mask fill
    port, ref = _module_pair(False, False, AttnMaskType.padding)
    mask = np.random.RandomState(4).rand(2, 1, 16, 16) > 0.7
    mask[..., 0] = False
    got = port(torch.from_numpy(scores), torch.from_numpy(mask))
    want = ref(jnp.asarray(scores), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_fp16_model_takes_the_fused_causal_path_as_jax():
    # fp32 scores into an fp16 model's softmax: the fused kernels, fp16
    # probabilities out (the exit cast)
    scores = np.random.RandomState(5).randn(2, 2, 32, 32).astype(np.float32)
    port, ref = _module_pair(True, False, AttnMaskType.causal)
    assert port.is_kernel_available(None, 2, 2, 32, 32)
    got = port(torch.from_numpy(scores), None)
    want = ref(jnp.asarray(scores), None)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=1e-3)


def test_fused_padding_softmax_raises_naming_row_5():
    port, _ = _module_pair(True, False, AttnMaskType.padding)
    scores = torch.zeros(1, 2, 8, 8)
    with pytest.raises(NotImplementedError, match="row 5"):
        port(scores, torch.zeros(1, 1, 8, 8, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="row 5"):
        port(scores, None)
