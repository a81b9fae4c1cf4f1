"""Port parity for ``amp.autocast`` (the O1/O4 op-level casts): the twins
of ``tests/test_autocast.py``'s table cases, each run on the same numpy
inputs through JAX's ``autocast`` and the port's, output dtypes compared
exactly and values within a stated tolerance.

Tolerances: products and sums are the same rounded operands summed in
fp32 in another order, so fp32 outputs hold to 1e-5 relative (5e-5
absolute on O(1) values); a bf16/fp16 output to one ulp of its dtype
(2^-7 / 2^-10 relative).  JAX classifies the primitives of ``jnp``'s
decompositions, so some of its functions round inside where the port's
one op does not (``ROUNDS_INSIDE``): softmax and log-softmax subtract the
row max in bf16 (1e-2 relative, 1e-3 absolute); norm squares and std
takes its variance in bf16 (2^-8 relative); GELU rounds its constants to
bf16 (1e-3 relative).  Flash attention's bf16 output holds to 2e-2 (the
kernels' plain versions on both sides, bf16 o rounded from fp32 sums in
other orders), its gradients under a fixed weighting of the output to
5e-2 of their largest magnitude.  The
JAX side runs at HIGHEST matmul precision: its CPU dots otherwise
truncate fp32 operands to bf16, which the autocast's upcast fp16
operands must not see again.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from apex_tpu import amp as jax_amp
from apex_tpu.amp.autocast import autocast as jax_autocast
from apex_tpu_torch import amp
from apex_tpu_torch._autocast_ctx import autocast_compute_dtype

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
JAXD = {v: jnp.dtype(k) for k, v in TORCH.items()}
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
        torch.float16: 2.0 ** -10}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module's small tensors: on a loaded
    machine a pool of threads costs more than the ops themselves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, *shape, pos=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.5 if pos else x


def _both(x, dtype):
    return (jnp.asarray(x).astype(JAXD[dtype]),
            torch.from_numpy(x).to(dtype))


def _hold(got, want, rtol=None, atol=5e-5):
    """dtype exactly JAX's; values within ``rtol`` of the output dtype's
    ulp (relative) plus ``atol``."""
    assert str(got.dtype).replace("torch.", "") == jnp.dtype(want.dtype).name
    g = got.detach().float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    tol = RTOL[got.dtype] if rtol is None else rtol
    np.testing.assert_allclose(g, w, rtol=tol, atol=atol)


def _run(jfn, tfn, *arrays, dtype=torch.bfloat16, compute=torch.bfloat16):
    js, ts = zip(*(_both(a, dtype) for a in arrays))
    with jax.default_matmul_precision("highest"):
        want = jax_autocast(jfn, compute_dtype=JAXD[compute])(*js)
    got = amp.autocast(tfn, compute_dtype=compute)(*ts)
    return got, want


# --- low precision: matmul, linear, conv ----------------------------------

@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float16])
def test_matmul_runs_low_precision(in_dtype, compute):
    a, b = _np(0, 8, 16), _np(1, 16, 8)
    got, want = _run(lambda x, y: x @ y, lambda x, y: x @ y, a, b,
                     dtype=in_dtype, compute=compute)
    # fp32 operands: rounded to the compute dtype, the result fp32
    _hold(got, want, rtol=None if in_dtype != torch.float32 else 1e-5,
          atol=1e-4 if compute == torch.float16 else 5e-5)
    if in_dtype == torch.float32:
        rounded = (torch.from_numpy(a).to(compute).float()
                   @ torch.from_numpy(b).to(compute).float())
        assert torch.equal(got, rounded)


@pytest.mark.parametrize("form", ["linear", "matmul_batched", "bmm",
                                  "addmm", "einsum"])
def test_products_fp32_out(form):
    x, w, bias = _np(2, 4, 6, 16), _np(3, 16, 8), _np(4, 8)
    jfn = {"linear": lambda x, w, b: x @ w + b,
           "matmul_batched": lambda x, w, b: x @ x.transpose(0, 2, 1),
           "bmm": lambda x, w, b: x @ x.transpose(0, 2, 1),
           "addmm": lambda x, w, b: b + x[0] @ w,
           "einsum": lambda x, w, b: jnp.einsum("bsh,ho->bso", x, w)}[form]
    tfn = {"linear": lambda x, w, b: F.linear(x, w.t(), b),
           "matmul_batched": lambda x, w, b: torch.matmul(
               x, x.transpose(1, 2)),
           "bmm": lambda x, w, b: torch.bmm(x, x.transpose(1, 2)),
           "addmm": lambda x, w, b: torch.addmm(b, x[0], w),
           "einsum": lambda x, w, b: torch.einsum("bsh,ho->bso", x, w)}[form]
    got, want = _run(jfn, tfn, x, w, bias, dtype=torch.float32)
    assert got.dtype == torch.float32
    _hold(got, want)


def test_conv_runs_low_precision():
    x, k = _np(5, 1, 3, 8, 8), _np(6, 4, 3, 3, 3)
    conv = lambda x, k: jax.lax.conv_general_dilated(  # noqa: E731
        x, k, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"))
    got, want = _run(conv, lambda x, k: F.conv2d(x, k, padding=1), x, k,
                     dtype=torch.float32)
    # no preferred type on the traced convolution: the compute dtype
    assert got.dtype == torch.bfloat16
    _hold(got, want)


# --- fp32 and fp32-accumulate -----------------------------------------------

FP32_CASES = {
    "exp": (jnp.exp, torch.exp),
    "log1p": (jnp.log1p, torch.log1p),
    "pow": (lambda v: v ** 3.1, lambda v: v ** 3.1),
    "softmax": (jax.nn.softmax, lambda v: torch.softmax(v, -1)),
    "log_softmax": (jax.nn.log_softmax, lambda v: F.log_softmax(v, -1)),
    "cumsum": (lambda v: jnp.cumsum(v, -1), lambda v: torch.cumsum(v, -1)),
    "gelu": (jax.nn.gelu, lambda v: F.gelu(v, approximate="tanh")),
    "tanh": (jnp.tanh, torch.tanh),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
    "rsqrt": (jax.lax.rsqrt, torch.rsqrt),
    "div": (lambda v: v / 3.0, lambda v: v / 3.0),
    "norm": (lambda v: jnp.linalg.norm(v, axis=-1),
             lambda v: torch.linalg.vector_norm(v, dim=-1)),
    "std": (lambda v: jnp.std(v, -1), lambda v: torch.std(v, -1,
                                                          correction=0)),
    "sum": (lambda v: jnp.sum(v, -1), lambda v: torch.sum(v, -1)),
    "mean": (lambda v: jnp.mean(v, -1), lambda v: v.mean(-1)),
    "var": (lambda v: jnp.var(v, -1), lambda v: torch.var(v, -1,
                                                          correction=0)),
}


# (rtol, atol) where JAX's decomposition rounds inside the op
ROUNDS_INSIDE = {"softmax": (1e-2, 1e-3), "log_softmax": (1e-2, 1e-3),
                 "norm": (2.0 ** -8, 0.0), "std": (2.0 ** -8, 0.0),
                 "gelu": (1e-3, 5e-5)}


@pytest.mark.parametrize("name", sorted(FP32_CASES))
def test_fp32_listed_ops(name):
    jfn, tfn = FP32_CASES[name]
    got, want = _run(jfn, tfn, _np(7, 4, 16, pos=True))
    # the blacklist ends in fp32; sum, mean and var accumulate in fp32
    # and return the input's dtype, as jnp's do
    accumulate = name in ("sum", "mean", "var")
    assert got.dtype == (torch.bfloat16 if accumulate else torch.float32)
    rtol, atol = ROUNDS_INSIDE.get(name, (None if accumulate else 2e-5,
                                          5e-5))
    _hold(got, want, rtol=rtol, atol=atol)


def test_fp32_softmax_numerics_preserved():
    x = _np(8, 4, 64) * 10
    got, _ = _run(jax.nn.softmax, lambda v: torch.softmax(v, -1), x)
    ref = torch.softmax(torch.from_numpy(x).bfloat16().float(), -1)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)


# --- promotion and passthrough ---------------------------------------------

def test_mixed_binary_promotes_widest():
    a, b = _both(_np(9, 4), torch.bfloat16), _both(_np(10, 4), torch.float32)
    want = jax_autocast(lambda x, y: x + y)(a[0], b[0])
    got = amp.autocast(lambda x, y: x + y)(a[1], b[1])
    _hold(got, want, rtol=1e-6)
    # a 0-d fp32 tensor promotes too, as a typed JAX scalar does
    got0 = amp.autocast(lambda x: x * torch.tensor(2.0))(a[1])
    want0 = jax_autocast(lambda x: x * jnp.float32(2.0))(a[0])
    _hold(got0, want0, rtol=1e-6)


def test_passthrough_matches_input():
    got, want = _run(lambda x: jnp.maximum(x, 0) * 2,
                     lambda x: torch.clamp_min(x, 0) * 2, _np(11, 4, 4))
    assert got.dtype == torch.bfloat16
    _hold(got, want, rtol=0, atol=0)


def test_inplace_and_stores_are_not_cast():
    x = torch.zeros(4, dtype=torch.bfloat16)
    y = torch.ones(4)

    def fn(x, y):
        x.add_(y)
        x[1:2] = y[:1] * 3
        return x

    out = amp.autocast(fn)(x, y)
    assert out is x and x.dtype == torch.bfloat16
    assert x.tolist() == [1.0, 3.0, 1.0, 1.0]


# --- autograd ---------------------------------------------------------------

def test_grad_through_autocast():
    w_np, x_np = np.full((8, 8), 0.5, np.float32), _np(12, 2, 8)

    def jloss(w):
        return jnp.sum((jnp.asarray(x_np) @ w) ** 2)

    with jax.default_matmul_precision("highest"):
        jg = jax.grad(jax_autocast(jloss))(jnp.asarray(w_np))
    w = torch.from_numpy(w_np).requires_grad_()
    loss = amp.autocast(lambda w: torch.sum((torch.from_numpy(x_np) @ w)
                                            ** 2))(w)
    loss.backward()
    assert w.grad.dtype == torch.float32
    # the operand cotangent is rounded to bf16, as JAX's transpose
    # through the casts rounds it: equal to one bf16 ulp
    _hold(w.grad, jg, rtol=2.0 ** -8)


@pytest.mark.parametrize("xs,ws", [((2, 16, 32), (32, 48)),
                                   ((4, 1, 16, 8), (3, 8, 12)),
                                   ((16, 8), (3, 8, 12)),
                                   ((3, 16, 8), (1, 8, 12))],
                         ids=["weight", "broadcast", "2d_x_batched_w",
                              "batched_x_w1"])
def test_card_product_rule_emulated(monkeypatch, xs, ws):
    """The card's product (``_MatmulF32``, its tensor-core fp32-output
    calls replaced by fp32 products of the same 16-bit operands, which
    the CPU has no form of) against its definition: the operands rounded
    to bf16, an fp32 product, the cotangent rounded to bf16, each
    operand's cotangent rounded once after its fp32 sums (those over
    broadcast batch dimensions too: rounding each batch's part first
    reads 10-63 bf16 ulps off).  Within one bf16 ulp (the same fp32
    sums, maybe in another order)."""
    import importlib

    ac = importlib.import_module("apex_tpu_torch.amp.autocast")
    monkeypatch.setattr(ac, "_bmm_f32",
                        lambda a, b: torch.bmm(a.float(), b.float()))
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(xs, generator=gen), torch.randn(ws, generator=gen)
    g = torch.randn(torch.broadcast_shapes(xs[:-2], ws[:-2])
                    + (xs[-2], ws[-1]), generator=gen)
    xc, wc = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = ac._cuda_matmul_f32(xc.to(bf), wc.to(bf))
    y.backward(g)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    yr = xr.to(bf).float() @ wr.to(bf).float()
    yr.backward(g.to(bf).float())
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for got, want in ((xc.grad, xr.grad), (wc.grad, wr.grad)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=2.0 ** -7, atol=1e-6)


def test_custom_function_rule_survives():
    class F2(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 100.0

    x = torch.tensor(3.0, requires_grad=True)
    amp.autocast(F2.apply)(x).backward()
    assert float(x.grad) == 100.0


# --- the fused entries: opaque, with flash and LN boundary casts ----------

@pytest.fixture(scope="module")
def flash_case():
    """JAX's flash attention (interpret mode) and LN block under O4 autocast,
    with its gradients: shared by the flash tests."""
    from apex_tpu.ops.flash_attention import flash_attention
    from apex_tpu.ops.layer_norm import layer_norm

    q, k, v = (_np(20 + i, 1, 2, 64, 64) for i in range(3))
    g, b = np.ones(64, np.float32) * 1.5, np.full(64, 0.25, np.float32)
    # a fixed weighting of the output: LN's plain sum has ~0 gradient
    r = _np(24, 1, 2, 64, 64)

    def block(q, k, v, g, b):
        return layer_norm(flash_attention(q, k, v, causal=True), g, b)

    att = jax_autocast(lambda q, k, v: flash_attention(q, k, v, causal=True),
                       compute_dtype=jnp.bfloat16)
    ac = jax_autocast(block, compute_dtype=jnp.bfloat16)
    args = [jnp.asarray(a) for a in (q, k, v, g, b)]
    grads = jax.grad(lambda *a: jnp.sum(ac(*a) * r),
                     argnums=(0, 1, 2, 3))(*args)
    return dict(np=(q, k, v, g, b), r=r, att=att(*args[:3]),
                block=ac(*args), grads=grads)


def test_flash_and_layer_norm_boundary_casts(flash_case):
    from apex_tpu_torch.ops import flash_attention
    from apex_tpu_torch.ops.layer_norm import layer_norm

    q, k, v, g, b = (torch.from_numpy(a).requires_grad_()
                     for a in flash_case["np"])
    att = amp.autocast(lambda q, k, v: flash_attention(q, k, v, causal=True))
    out = att(q, k, v)
    assert out.dtype == torch.bfloat16
    _hold(out, flash_case["att"], rtol=2e-2, atol=2e-2)

    def block(q, k, v, g, b):
        return layer_norm(flash_attention(q, k, v, causal=True), g, b)

    out2 = amp.autocast(block)(q, k, v, g, b)
    # LN is FP32-listed: the bf16 attention output is cast to fp32
    assert out2.dtype == torch.float32
    _hold(out2, flash_case["block"], rtol=5e-2, atol=5e-2)
    (out2 * torch.from_numpy(flash_case["r"])).sum().backward()
    for got, want, name in zip((q.grad, k.grad, v.grad, g.grad),
                               flash_case["grads"], "qkvg"):
        assert got.dtype == torch.float32, name
        w = np.asarray(want, np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=5e-2 * scale, err_msg=name)
    assert autocast_compute_dtype() is None


def test_packed_qkv_matches_unpacked_under_autocast(flash_case):
    from apex_tpu_torch.ops import flash_attention, flash_attention_qkv

    q, k, v = (torch.from_numpy(a) for a in flash_case["np"][:3])
    a1 = amp.autocast(lambda q, k, v: flash_attention(q, k, v, causal=True))(
        q, k, v)
    a2 = amp.autocast(lambda qkv: flash_attention_qkv(qkv, causal=True))(
        torch.stack([q, k, v]))
    assert a1.dtype == a2.dtype == torch.bfloat16
    assert torch.equal(a1, a2)


@pytest.mark.parametrize("entry", ["flash_e", "flash_e_reference",
                                   "partial", "layer_norm", "softmax",
                                   "masked_softmax", "xentropy", "moe"])
def test_fused_entries_are_opaque(entry):
    """Under autocast each entry computes exactly what it computes outside
    on its boundary-cast inputs: its body's own ops are not recast (a
    recast exp or product inside would change the bits)."""
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.ops import (flash_attention_e,
                                    flash_attention_e_reference,
                                    flash_attention_partial, layer_norm,
                                    moe_route_dispatch,
                                    scaled_masked_softmax,
                                    scaled_upper_triang_masked_softmax)

    t = lambda *s, seed=30: torch.from_numpy(_np(seed, *s))  # noqa: E731
    bf = torch.bfloat16
    cases = {
        "flash_e": (lambda x: flash_attention_e(x, causal=True),
                    t(1, 64, 2, 192), bf),
        "flash_e_reference": (
            lambda x: flash_attention_e_reference(x, causal=True),
            t(1, 64, 2, 192), bf),
        "partial": (lambda x: flash_attention_partial(x, x, x, causal=True,
                                                      q_offset=8)[0],
                    t(1, 2, 32, 64), bf),
        "layer_norm": (lambda x: layer_norm(x, None, None), t(8, 64).to(bf),
                       torch.float32),
        "softmax": (lambda x: scaled_upper_triang_masked_softmax(x, 0.5),
                    t(2, 16, 16).to(bf), None),
        "masked_softmax": (lambda x: scaled_masked_softmax(
            x, torch.zeros(1, 1, 16, 16, dtype=torch.bool), 0.5),
            t(1, 2, 16, 16).to(bf), None),
        "xentropy": (lambda x: softmax_cross_entropy_loss(
            x, torch.arange(8) % 32, 0.1, True), t(8, 32).to(bf), None),
        "moe": (lambda x: moe_route_dispatch(
            x, x[:, :4] * 2.0, capacity=4).buf, t(8, 16).to(bf),
            None),
    }
    fn, x, cast_to = cases[entry]
    inside = amp.autocast(fn)(x)
    outside = fn(x if cast_to is None else x.to(cast_to))
    assert inside.dtype == outside.dtype
    assert torch.equal(inside, outside)


def test_autocast_context_cleared():
    from apex_tpu_torch.ops import flash_attention

    q = torch.from_numpy(_np(40, 1, 1, 32, 64))
    assert autocast_compute_dtype() is None
    amp.autocast(lambda q: flash_attention(q, q, q))(q)
    assert autocast_compute_dtype() is None
    assert flash_attention(q, q, q).dtype == torch.float32
    # an exception inside the region leaves it too
    with pytest.raises(ZeroDivisionError):
        amp.autocast(lambda: 1 / 0)()
    assert autocast_compute_dtype() is None
    assert torch.ones(2).exp().dtype == torch.float32


# --- registration, policies -----------------------------------------------

def test_register_decorators():
    probe = lambda *xs: tuple(x.dtype for x in xs)  # noqa: E731
    assert amp.half_function(probe)(torch.ones(2))[0] == torch.float16
    assert amp.bfloat16_function(probe)(torch.ones(2))[0] == torch.bfloat16
    assert amp.float_function(probe)(
        torch.ones(2, dtype=torch.bfloat16))[0] == torch.float32
    a, b = amp.promote_function(probe)(torch.ones(2, dtype=torch.bfloat16),
                                       torch.ones(2))
    assert a == b == torch.float32
    # the JAX decorators agree
    from apex_tpu.amp.autocast import (bfloat16_function, float_function,
                                       half_function, promote_function)
    jprobe = lambda *xs: tuple(x.dtype for x in xs)  # noqa: E731
    assert half_function(jprobe)(jnp.ones(2))[0] == jnp.float16
    assert bfloat16_function(jprobe)(jnp.ones(2))[0] == jnp.bfloat16
    assert float_function(jprobe)(jnp.ones(2, jnp.bfloat16))[0] == \
        jnp.float32
    assert promote_function(jprobe)(jnp.ones(2, jnp.bfloat16),
                                    jnp.ones(2))[0] == jnp.float32


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4", "O5"])
def test_policy_selects_dtype_or_is_identity(level):
    fn = lambda a: a @ a  # noqa: E731
    jp, tp = jax_amp.get_policy(level), amp.get_policy(level)
    if not tp.cast_ops:
        assert jax_autocast(fn, policy=jp) is fn
        assert amp.autocast(fn, policy=tp) is fn
        return
    x = _np(50, 8, 8)
    with jax.default_matmul_precision("highest"):
        want = jax_autocast(fn, policy=jp)(jnp.asarray(x))
    got = amp.autocast(fn, policy=tp)(torch.from_numpy(x))
    _hold(got, want, atol=1e-4)
    rounded = torch.from_numpy(x).to(tp.cast_ops_type).float()
    assert torch.equal(got, rounded @ rounded)
