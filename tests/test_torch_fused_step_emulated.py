"""Row 19's leaf-table steps (``sgd_leaves_kernel`` in
``apex_tpu_torch/csrc/fused_sgd.cu``, ``adam_leaves_kernel`` in
``csrc/fused_adam.cu``, over ``csrc/optim_step.cuh``'s table) run on the
CPU and are held bitwise against their plain per-leaf versions.

The sources are built with g++ over ``tests/cuda_emu`` (``emulate.py``,
one host thread a CUDA thread; the ``__f*_rn`` intrinsics one IEEE
operation each, never contracted), and the port's own wrapper packs the
table and launches them: the grouping by (g, lowp) dtype pair, a launch a
table's worth of leaves, the binary search from a block to its leaf, the
chunks of a leaf, the vector loads and their scalar tail, the scalar loop
of a leaf whose pointers are not all aligned.  The leaves cover every
(g, lowp) pair, odd lengths, leaves of 1 and of 0 elements, leaves of
several chunks (at a small chunk, and at chunks of two unrolled passes),
a misaligned view of each kind of buffer, and more leaves than one table
holds.  The Adam step's bf16/fp16-parameter lane (amp's policies without
master weights: the parameter stepped in fp32 and rounded back, no copy)
is held the same way, and against JAX's ``adam_step`` on a parameter in
that dtype in interpret mode: the parameter within one ulp of its dtype
(XLA's CPU compiler contracts the kernel's multiply-adds, so a rounding
may flip), each fp32 moment within two fp32 ulps of its larger term
(``beta * m`` or ``(1 - beta) * g``: a cancelled sum differs by many of
its own ulps).

One stand-in on the plain side: torch's CPU ``sqrt`` is not correctly
rounded (one fp32 ulp off on some inputs, against numpy, on an AVX-512
build), while the card's ``__fsqrt_rn`` and torch's CUDA ``sqrt`` are;
the Adam holds run the plain version with numpy's sqrt, which rounds
correctly, as the card's plain version does.
"""
import importlib
import math

import numpy as np
import pytest
import torch

from cuda_emu import emulate

fo = importlib.import_module("apex_tpu_torch.ops.fused_optim")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
PAIRS = [(g, l) for g in (F32, BF16, F16) for l in (None, BF16, F16)]
SMALL_CHUNK = 256
# (nesterov, dampening, wd_after_momentum, first_run)
SGD_FLAGS = [(False, 0.0, False, False), (True, 0.0, False, False),
             (False, 0.1, True, False), (False, 0.1, False, True),
             (True, 0.0, True, True)]
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-2)
ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
            bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("fused_step_emu"),
                         ("fused_sgd", "fused_adam"))


@pytest.fixture
def exact_sqrt(monkeypatch):
    """torch.sqrt on CPU tensors through numpy's correctly rounded one."""
    monkeypatch.setattr(torch, "sqrt", lambda x: torch.from_numpy(
        np.sqrt(x.detach().numpy())))


@pytest.fixture
def launches(emulated, monkeypatch):
    """Route the wrappers to the emulated libraries at ``SMALL_CHUNK``;
    the list the launches are counted into, by name."""
    emulate.route(monkeypatch, emulated, fo)
    monkeypatch.setattr(fo, "_CAPACITY", {})
    monkeypatch.setattr(fo, "STEP_CHUNK", SMALL_CHUNK)
    seen = []
    monkeypatch.setattr(fo, "bump", seen.append)
    return seen


def _spec():
    """(length, g dtype, lowp dtype, misaligned buffer or None) a leaf."""
    out = [(n, g, l, None) for (g, l), n in zip(
        PAIRS, (37, 301, 1001, 3, 515, 255, 4 * SMALL_CHUNK + 7, 64, 129))]
    out += [(1, BF16, BF16, None), (0, F32, None, None),
            (3 * SMALL_CHUNK, F32, None, None),
            (700, BF16, BF16, "g"), (700, BF16, BF16, "p"),
            (333, F16, F16, "state"), (333, BF16, BF16, "lowp")]
    return out


def _leaves(spec, states, seed):
    """Seeded leaves: (g, [p, state...], lowp), each buffer a view one
    element into its storage where the spec names it."""
    rng = np.random.RandomState(seed)
    out = []
    for n, gdt, ldt, off in spec:
        def buf(vals, dt, name):
            t = torch.from_numpy(vals.astype(np.float32)).to(dt)
            if off == name:
                t = torch.cat([t[:1], t])[1:]
            return t
        g = buf(rng.randn(n) * 3, gdt, "g")
        st = [buf(rng.randn(n), F32, "p")] + [
            buf(np.abs(rng.randn(n)) * 0.1, F32, "state")
            for _ in range(states)]
        lowp = None if ldt is None else buf(np.zeros(n), ldt, "lowp")
        out.append((g, st, lowp))
    return out


def _copy(t):
    """A copy of ``t`` at the same offset into a storage of its own (a
    misaligned view stays misaligned)."""
    off = t.storage_offset()
    c = torch.empty(off + t.numel(), dtype=t.dtype)[off:]
    return c.copy_(t)


def _clone(leaves):
    return [(g, [_copy(t) for t in st], None if l is None else _copy(l))
            for g, st, l in leaves]


def _run(launch, plain, leaves, hyp):
    """The emulated launch and the plain version on clones of ``leaves``;
    every output bitwise equal."""
    got, want = _clone(leaves), _clone(leaves)
    for g, st, lowp in want:
        plain(g, *st, lowp, **hyp)
    launch([x[0] for x in got], *zip(*[x[1] for x in got]),
           [x[2] for x in got], **hyp)
    for i, ((_, sg, lg), (_, sw, lw)) in enumerate(zip(got, want)):
        for k, (a, b) in enumerate(zip(sg + [lg], sw + [lw])):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), \
                    f"leaf {i} buffer {k}: max |err| " \
                    f"{float((a.float() - b.float()).abs().max())}"


def _groups(spec):
    out = {}
    for n, gdt, ldt, _ in spec:
        if n:
            out[(gdt, ldt)] = out.get((gdt, ldt), 0) + 1
    return out


@pytest.mark.parametrize("nesterov,dampening,wd_after,first", SGD_FLAGS)
def test_sgd_leaves_bitwise(launches, nesterov, dampening, wd_after, first):
    spec = _spec()
    _run(fo._sgd_leaves_launch, fo.sgd_step_reference, _leaves(spec, 1, 1),
         dict(SGD, nesterov=nesterov, dampening=dampening,
              wd_after_momentum=wd_after, first_run=first))
    # one launch a dtype pair: every group fits one table
    assert launches == ["sgd_step"] * len(_groups(spec))


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_leaves_bitwise(launches, exact_sqrt, adam_w_mode):
    spec = _spec()
    _run(fo._adam_leaves_launch, fo.adam_step_reference, _leaves(spec, 2, 2),
         dict(ADAM, adam_w_mode=adam_w_mode))
    assert launches == ["adam_step"] * len(_groups(spec))


@pytest.mark.parametrize("which", ["sgd", "adam"])
def test_more_leaves_than_a_table(launches, exact_sqrt, which):
    lib, states = {"sgd": ("fused_sgd", 1), "adam": ("fused_adam", 2)}[which]
    cap = fo.step_capacity(lib)
    assert 60 <= cap <= 100, cap     # a 4 KB parameter block
    spec = [(5 + i % 9, BF16, BF16, "p" if i == cap else None)
            for i in range(cap + 6)]
    spec += [(11, F32, None, None), (2, F16, F16, None)]
    leaves = _leaves(spec, states, 3)
    if which == "sgd":
        _run(fo._sgd_leaves_launch, fo.sgd_step_reference, leaves,
             dict(SGD, nesterov=False, dampening=0.0,
                  wd_after_momentum=False, first_run=False))
    else:
        _run(fo._adam_leaves_launch, fo.adam_step_reference, leaves,
             dict(ADAM, adam_w_mode=True))
    want = sum(math.ceil(k / cap) for k in _groups(spec).values())
    assert want == 4 and launches == [f"{which}_step"] * want


def test_large_chunks(launches, exact_sqrt, monkeypatch):
    # leaves of several 8192-element chunks: two passes of the block's
    # unrolled loads a chunk, a partial last chunk with its scalar tail
    monkeypatch.setattr(fo, "STEP_CHUNK", 8192)
    spec = [(2 * 8192 + 4099, BF16, BF16, None), (8192 + 1, F32, None, None)]
    _run(fo._sgd_leaves_launch, fo.sgd_step_reference, _leaves(spec, 1, 4),
         dict(SGD, nesterov=True, dampening=0.0, wd_after_momentum=False,
              first_run=False))
    _run(fo._adam_leaves_launch, fo.adam_step_reference, _leaves(spec, 2, 5),
         dict(ADAM, adam_w_mode=True))
    assert launches == ["sgd_step"] * 2 + ["adam_step"] * 2


def test_bad_leaves_raise(launches):
    g, p, m = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    hyp = dict(SGD, nesterov=False, dampening=0.0, wd_after_momentum=False,
               first_run=False)
    with pytest.raises(ValueError, match="contiguous"):
        fo._sgd_leaves_launch([g], [p], [torch.zeros(7)], [None], **hyp)
    with pytest.raises(ValueError, match="grads, masters"):
        fo._sgd_leaves_launch([g, g], [p], [m], [None], **hyp)
    assert launches == []


def _lowp_param_leaves(pdt, seed):
    """Leaves whose stepped tensor is a ``pdt`` parameter with no copy:
    g mostly in ``pdt`` (fp32 once clipped), odd lengths, several chunks,
    a misaligned parameter view."""
    rng = np.random.RandomState(seed)
    out = []
    for n, gdt, off in ((37, pdt, False), (4 * SMALL_CHUNK + 7, pdt, False),
                        (515, F32, False), (700, pdt, True), (1, pdt, False),
                        (0, pdt, False)):
        g = torch.from_numpy((rng.randn(n) * 3).astype(np.float32)).to(gdt)
        p = torch.from_numpy((rng.randn(n) * 0.05).astype(np.float32)).to(pdt)
        if off:
            p = torch.cat([p[:1], p])[1:]
        st = [p] + [torch.from_numpy(
            (np.abs(rng.randn(n)) * 0.1).astype(np.float32))
            for _ in range(2)]
        out.append((g, st, None))
    return out


@pytest.mark.parametrize("pdt", [BF16, F16])
def test_adam_lowp_param_lane_bitwise(launches, exact_sqrt, pdt):
    leaves = _lowp_param_leaves(pdt, 7)
    _run(fo._adam_leaves_launch, fo.adam_step_reference, leaves,
         dict(ADAM, adam_w_mode=True))
    # a launch a (g, p) lane: pdt gradients, and the fp32 one
    assert launches == ["adam_step_lowp"] * 2


@pytest.mark.parametrize("pdt", [BF16, F16])
def test_adam_lowp_param_lane_matches_jax(exact_sqrt, pdt):
    import jax
    import jax.numpy as jnp

    from apex_tpu.ops import fused_optim as jax_fo

    (g, (p, m, v), _), = [x for x in _lowp_param_leaves(pdt, 8)
                          if x[0].numel() == 4 * SMALL_CHUNK + 7]
    jdt = {BF16: jnp.bfloat16, F16: jnp.float16}[pdt]
    flats, restore = jax_fo.flatten_for_kernel(
        *(jnp.asarray(t.float().numpy()).astype(d) for t, d in
          ((g, jdt), (p, jdt), (m, jnp.float32), (v, jnp.float32))))
    outs = jax_fo.adam_step(*flats, **ADAM, adam_w_mode=True, interpret=True)
    jp, jm, jv = (np.asarray(restore(o).astype(jnp.float32)) for o in outs)
    assert outs[0].dtype == jdt and outs[1].dtype == jnp.float32
    pp, mm, vv = p.clone(), m.clone(), v.clone()
    fo.adam_step_reference(g, pp, mm, vv, None, **ADAM)
    assert pp.dtype == pdt and mm.dtype == F32
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(jp), 1e-30)))
                  - {BF16: 7, F16: 10}[pdt])
    assert np.all(np.abs(pp.float().numpy() - jp) <= ulp)
    gf = g.float().numpy()
    for got, want, terms in (
            (mm, jm, (0.9 * m.numpy(), 0.1 * gf)),
            (vv, jv, (0.999 * v.numpy(), 0.001 * gf * gf))):
        big = np.maximum(*(np.abs(t) for t in terms))
        assert np.all(np.abs(got.numpy() - want) <= 2 * 2.0 ** -23 * big)
    del jax
