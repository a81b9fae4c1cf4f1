"""Port parity: the causal scaled softmax and its backward
(``apex_tpu_torch.ops.scaled_upper_triang_masked_softmax``) against
``apex_tpu.ops.scaled_softmax.scaled_upper_triang_masked_softmax`` (its
Pallas ``_causal_fwd`` and ``_softmax_backward`` in CPU interpret mode),
the padding-mask softmax (``scaled_masked_softmax``, row 5, with row 4
under it) against JAX's (its Pallas ``_masked_fwd``), and
``FusedScaleMaskSoftmax``'s dispatch, causal and padding, against the
JAX module's.

The forward and the backward (``jax.vjp`` against the port's autograd)
take the same numpy scores at (4, 64, 64) and (3, 300, 300) (two of the
JAX kernel's 256-row blocks, the second padded), scale 0.125 and 1.0, in
fp32 and fp16; the forward is also held against a float64 softmax of
the same scores.  Tolerances: 1e-6 in fp32 (the same fp32 expression;
exp and the row sums may differ by an ulp or two of values <= 1), 1e-3
in fp16 (one fp16 ulp of a probability near 1 is 2^-11 ~ 4.9e-4).
Masked entries are exactly 0 on both sides.

The padding-mask softmax takes (3, 2, 40, 72) scores with a BERT-style
(b, 1, sq, sk) mask (batch row 0 all pad, so its every query row is
fully masked) in fp32, fp16 and bf16, scale 0.125: fp32 1e-6 and fp16
1e-3 as above; bf16 2^-8 for y (one bf16 ulp of a probability near 1:
both sides round one fp32 value) and 2^-7 for dx (which also carries
the saved y's one-ulp difference).  Measured: fp32 3.0e-8 for y and
5.6e-9 for dx; fp16 and bf16 equal bit for bit.  Fully masked rows are
1/sk on both sides; live rows put exactly 0 on masked keys.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops.scaled_softmax import \
    scaled_masked_softmax as jax_masked_softmax
from apex_tpu.ops.scaled_softmax import \
    scaled_upper_triang_masked_softmax as jax_causal_softmax
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.functional.fused_softmax import \
    FusedScaleMaskSoftmax as JaxFusedSoftmax
from apex_tpu_torch.ops import (causal_softmax_reference, launch_counts,
                                masked_softmax_reference,
                                reset_launch_counts, scaled_masked_softmax,
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


def _masked_inputs(shape, dtype, seed):
    """Scores (b, np, sq, sk), dy, and a (b, 1, sq, sk) BERT-style mask
    (True = masked): each batch row keeps its first L keys and queries,
    so every padded query row is fully masked; batch row 0 is all pad."""
    b, np_, sq, sk = shape
    x, dy = _inputs(shape, dtype, seed)
    lens = np.random.RandomState(seed + 1).randint(1, sk + 1, b)
    lens[0] = 0
    real = np.arange(sk)[None, :] < lens[:, None]
    keep = real[:, :sq, None] & real[:, None, :]
    return x, dy, ~keep[:, None]


@pytest.mark.parametrize("dtype", [np.float32, np.float16, "bfloat16"])
def test_masked_forward_and_backward_match_jax(dtype):
    # row 5 (the padding-mask forward) and row 4 under it, against JAX's
    # scaled_masked_softmax and its vjp; fully masked query rows come out
    # uniform, 1/sk, on both sides (the finite -1e30 fill)
    shape, scale = (3, 2, 40, 72), 0.125
    bf16 = dtype == "bfloat16"
    x, dy, mask = _masked_inputs(shape, np.float32 if bf16 else dtype, 7)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (JAXD[dtype], TORCH[dtype])
    # bf16: one bf16 ulp of a probability near 1 (2^-8), twice for dx,
    # which also carries a one-ulp difference of the saved y
    tol = 2.0 ** -8 if bf16 else TOL[dtype]
    btol = 2 * tol if bf16 else tol
    jx, jdy = jnp.asarray(x).astype(jd), jnp.asarray(dy).astype(jd)
    y_j, vjp = jax.vjp(lambda a: jax_masked_softmax(a, jnp.asarray(mask),
                                                    scale), jx)
    dx_j, = vjp(jdy)
    xt = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    xt.requires_grad_(True)
    y_t = scaled_masked_softmax(xt, torch.from_numpy(mask), scale)
    y_t.backward(torch.from_numpy(np.array(jdy.astype(jnp.float32)))
                 .to(td))
    assert y_t.dtype == td and xt.grad.dtype == td
    yt, gt = y_t.detach().float().numpy(), xt.grad.float().numpy()
    np.testing.assert_allclose(yt, np.asarray(y_j.astype(jnp.float32)),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(gt, np.asarray(dx_j.astype(jnp.float32)),
                               rtol=0, atol=btol)
    dead = mask[:, 0].all(-1)                  # (b, sq) fully masked
    assert dead[0].all() and dead.sum() > shape[2]
    assert np.isfinite(yt).all() and np.isfinite(gt).all()
    np.testing.assert_allclose(yt.transpose(0, 2, 1, 3)[dead],
                               1.0 / shape[3], rtol=0, atol=tol / 8)
    # live rows put exactly 0 on masked keys
    live = np.broadcast_to(~dead[:, None, :, None] & mask, shape)
    assert (yt[live] == 0).all()


def test_masked_plain_version_is_the_kernel_math():
    # the plain version alone: -1e30 fill, a fully masked row uniform,
    # the mask shared by the heads
    x = torch.randn(2, 3, 4, 6, generator=torch.Generator().manual_seed(2))
    mask = torch.zeros(2, 1, 4, 6, dtype=torch.bool)
    mask[0, 0, :, 4:] = True
    mask[1, 0, 2] = True
    y = masked_softmax_reference(x, mask, 0.5)
    want = torch.softmax((x * 0.5).masked_fill(mask, float("-inf")), -1)
    live = ~mask.all(-1, keepdim=True).expand_as(y)
    torch.testing.assert_close(y[live], want[live], rtol=0, atol=1e-7)
    torch.testing.assert_close(y[:, :, 2][1], torch.full((3, 6), 1 / 6))
    assert (y[0][:, :, 4:] == 0).all()


@pytest.mark.parametrize("with_mask", [True, False])
def test_fp16_model_takes_the_fused_padding_path_as_jax(with_mask):
    # the padding branch of FusedScaleMaskSoftmax: fp32 scores into an
    # fp16 model's softmax go through the padding-mask kernel (its plain
    # version here), fp16 probabilities out.  With no mask the branch
    # means an all-zero (b, 1, sq, sk) mask; the JAX module's mask=None
    # line reads the shape before assigning it (UnboundLocalError,
    # apex_tpu/transformer/functional/fused_softmax.py:100-101), so the
    # port is held against the JAX module given that all-zero mask
    scores = np.random.RandomState(6).randn(2, 2, 24, 24).astype(np.float32)
    _, _, mask = _masked_inputs((2, 2, 24, 24), np.float32, 8)
    port, ref = _module_pair(True, False, AttnMaskType.padding)
    assert port.is_kernel_available(None, 2, 2, 24, 24)
    if not with_mask:
        mask = np.zeros_like(mask)
    got = port(torch.from_numpy(scores),
               torch.from_numpy(mask) if with_mask else None)
    want = ref(jnp.asarray(scores), jnp.asarray(mask))
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=1e-3)
    if not with_mask:     # no mask: the plain softmax of the scaled rows
        np.testing.assert_allclose(
            got.float().numpy(),
            torch.softmax(torch.from_numpy(scores) * 0.125, -1).numpy(),
            rtol=0, atol=1e-3)
