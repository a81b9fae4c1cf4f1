"""Port parity: row 19's four optax-style update bodies
(``apex_tpu_torch.ops.adam_update``, ``adagrad_update``,
``novograd_update``, ``sgd_update``; on the CPU their plain versions)
against the JAX package's Pallas bodies in interpret mode
(``apex_tpu.ops.fused_optim.*_update(..., interpret=True)``) on the same
seeded numpy inputs, over every flag, with fp32 and bf16 parameters and
gradients.

Tolerance: every fp32 output (an fp32 delta, the new state) within 1e-6
of the output's max |x|; a bf16 delta within one bf16 ulp of the JAX
element.  The port rounds after every operation (as its CUDA kernels do,
bit for bit); XLA's CPU compiler contracts the JAX kernels' multiply-adds
into FMAs, which moves results by about an fp32 ulp of their operands
(measured over these cases: fp32 outputs at most 3.7e-7 of max |x|, bf16
deltas at most 1.0 ulp).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.ops import fused_optim as jfo
from apex_tpu_torch.ops import (adagrad_update, adam_update,
                                novograd_update, sgd_update)
from apex_tpu_torch.ops.fused_optim import check_update_buffers

N = 4096 + 37                # not a multiple of 128, nor of 4
RTOL = 1e-6
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (nesterov, dampening, wd_after_momentum, first_run)
SGD_FLAGS = [(False, 0.0, False, False), (True, 0.0, False, False),
             (False, 0.1, True, False), (False, 0.1, False, True),
             (True, 0.0, True, True)]


def _inputs(seed, gdt, pdt, states):
    """g and p in their dtypes (JAX and torch alike), fp32 state."""
    rng = np.random.RandomState(seed)
    g = jnp.asarray(rng.randn(N).astype(np.float32)).astype(DTYPES[gdt][0])
    p = jnp.asarray(rng.randn(N).astype(np.float32)).astype(DTYPES[pdt][0])
    st = [np.abs(rng.randn(N) * 0.5).astype(np.float32) + 0.01
          for _ in range(states)]
    return g, p, st


def _torch(x, dt):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        DTYPES[dt][1])


def _run_jax(fn, g, p, st, **kw):
    """The JAX body on LANE-padded buffers, cut back to N."""
    flats, restore = jfo.flatten_for_kernel(g, p, *map(jnp.asarray, st))
    return [np.asarray(restore(o).astype(jnp.float32))
            for o in fn(*flats, interpret=True, **kw)]


def _bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (fp32 values)."""
    a = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _hold(got, want, pdt):
    """The delta (first) by ``pdt``'s rule, the state within RTOL."""
    d = got[0].float().numpy()
    if pdt == "bf16":
        assert np.all(np.abs(d - want[0]) <= _bf16_ulp(want[0]))
    else:
        assert np.abs(d - want[0]).max() <= RTOL * np.abs(want[0]).max()
    for a, b in zip(got[1:], want[1:]):
        a = a.numpy()
        assert a.dtype == np.float32
        assert np.abs(a - b).max() <= RTOL * np.abs(b).max()
    assert got[0].dtype == DTYPES[pdt][1]


@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("gdt,pdt", [("fp32", "fp32"), ("bf16", "fp32"),
                                     ("bf16", "bf16"), ("fp32", "bf16")])
def test_adam_update_matches_jax(gdt, pdt, adam_w):
    g, p, (m, v) = _inputs(1, gdt, pdt, 2)
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.05,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              adam_w_mode=adam_w)
    want = _run_jax(jfo.adam_update, g, p, (m, v), **kw)
    got = adam_update(_torch(g, gdt), _torch(p, pdt), torch.from_numpy(m),
                      torch.from_numpy(v), **kw)
    _hold(got, want, pdt)


@pytest.mark.parametrize("gdt,pdt", [("fp32", "fp32"), ("bf16", "fp32"),
                                     ("bf16", "bf16"), ("fp32", "bf16")])
def test_adagrad_update_matches_jax(gdt, pdt):
    g, p, (h,) = _inputs(2, gdt, pdt, 1)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.05)
    want = _run_jax(jfo.adagrad_update, g, p, (h,), **kw)
    got = adagrad_update(_torch(g, gdt), _torch(p, pdt), torch.from_numpy(h),
                         **kw)
    _hold(got, want, pdt)


@pytest.mark.parametrize("beta3", [1.0 - 0.95, 1.0])
@pytest.mark.parametrize("gdt,pdt", [("fp32", "fp32"), ("bf16", "fp32"),
                                     ("bf16", "bf16"), ("fp32", "bf16")])
def test_novograd_update_matches_jax(gdt, pdt, beta3):
    g, p, (m, denom) = _inputs(3, gdt, pdt, 2)
    kw = dict(lr=1e-2, beta1=0.95, beta3=beta3, weight_decay=0.05,
              bias_correction1=1 - 0.95 ** 2)
    want = _run_jax(jfo.novograd_update, g, p, (m, denom), **kw)
    got = novograd_update(_torch(g, gdt), _torch(p, pdt),
                          torch.from_numpy(m), torch.from_numpy(denom), **kw)
    _hold(got, want, pdt)


@pytest.mark.parametrize("gdt,pdt", [("fp32", "fp32"), ("bf16", "fp32"),
                                     ("bf16", "bf16")])
@pytest.mark.parametrize("nesterov,dampening,wd_after,first", SGD_FLAGS)
def test_sgd_update_matches_jax(nesterov, dampening, wd_after, first, gdt,
                                pdt):
    g, p, (mom,) = _inputs(4, gdt, pdt, 1)
    kw = dict(lr=0.1, momentum=0.9, dampening=dampening, weight_decay=0.05,
              nesterov=nesterov, wd_after_momentum=wd_after)
    want = _run_jax(jfo.sgd_update, g, p, (mom,), first_run=float(first),
                    **kw)
    got = sgd_update(_torch(g, gdt), _torch(p, pdt), torch.from_numpy(mom),
                     first_run=first, **kw)
    _hold(got, want, pdt)


def test_update_forms_return_new_tensors():
    g, p, (m, v) = _inputs(5, "fp32", "fp32", 2)
    tg, tp, tm, tv = _torch(g, "fp32"), _torch(p, "fp32"), \
        torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
    d, m2, v2 = adam_update(tg, tp, tm, tv, lr=1e-2, beta1=0.9, beta2=0.999,
                            eps=1e-8, weight_decay=0.0, bias_correction1=0.1,
                            bias_correction2=0.001)
    # the inputs are read only, as the JAX functions' arrays are
    assert np.array_equal(tm.numpy(), m) and np.array_equal(tv.numpy(), v)
    assert not any(t.data_ptr() in (tg.data_ptr(), tp.data_ptr(),
                                    tm.data_ptr(), tv.data_ptr())
                   for t in (d, m2, v2))


def test_check_update_buffers_raises():
    g = torch.zeros(64, dtype=torch.bfloat16)
    p = torch.zeros(64)
    check_update_buffers("t", g, p, (torch.zeros(64), torch.zeros(64)))
    # a non-contiguous state buffer, g and p
    with pytest.raises(ValueError, match="state"):
        check_update_buffers("t", g, p, (torch.zeros(128)[::2],))
    with pytest.raises(ValueError, match="g must"):
        check_update_buffers("t", torch.zeros(128)[::2], p, ())
    with pytest.raises(ValueError, match="p must"):
        check_update_buffers("t", g, torch.zeros(16, 4).t(), ())
    # lengths that differ
    with pytest.raises(ValueError, match="state"):
        check_update_buffers("t", g, p, (torch.zeros(63),))
    with pytest.raises(ValueError, match="g must"):
        check_update_buffers("t", torch.zeros(65), p, ())
    # a dtype the kernels do not take
    with pytest.raises(ValueError, match="state"):
        check_update_buffers("t", g, p, (torch.zeros(64, dtype=torch.half),))
    with pytest.raises(ValueError, match="p must"):
        check_update_buffers("t", g, torch.zeros(64, dtype=torch.float64),
                             ())


def test_update_forms_refuse_other_devices():
    meta = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sgd_update(meta, meta, meta, lr=0.1, momentum=0.9, dampening=0.0,
                   weight_decay=0.0, first_run=True)
