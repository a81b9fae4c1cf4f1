"""Row 18's MoE routing and dispatch kernels
(``apex_tpu_torch/csrc/moe_routing.cu``) run on the CPU and are held
against their plain version, ``moe_route_dispatch_reference``.

The source is built with g++ over ``tests/cuda_emu`` (``emulate.py``, one
host thread a CUDA thread, warp shuffles through a table of the warp's
lanes, the blocks of a launch one after another).  The launcher's own
routing runs: at T <= 32 one launch, ``dispatch_kernel<W, true>``, whose
every block routes the tokens itself and spreads the copy and the zero
rows over the grid (capped at two blocks an SM of the stand-in card's 8);
above, ``route_kernel`` then ``dispatch_kernel<W, false>``, whose blocks
sum the counts of the blocks and choices before them by warp reductions.
The cases are ``chip_smoke.py``'s off-grain shapes (E 5 and 40, H 100, T
130 and 33), T = 32 and 33 around the one-launch boundary, the serve's
decode tick in miniature, top 1 and top 2 under both second policies, and
rows of 16-, 4- and 2-byte words (fp32 H 100, bf16 H 100 and H 99).

The hold is ``chip_smoke.py``'s: expert_index, slot, keep and buf exactly
equal; the gates within ``GATE_TOL`` (the same fp32 expressions,
max-subtracted ``expf``, the sum, the divide, but the sum over the experts
a warp butterfly here and torch's own order in the plain version, with
the host's ``expf``), the aux loss within ``AUX_RTOL`` (an fp32 sum over
tokens in another order).  That the gates keep the earlier kernel's bits
is read on the card (``tools/kernel_variants.py moe``).
"""
import importlib

import numpy as np
import pytest
import torch

from cuda_emu import emulate

moe = importlib.import_module("apex_tpu_torch.ops.moe_routing")

F32, BF16 = torch.float32, torch.bfloat16
GATE_TOL = 1e-6
AUX_RTOL = 1e-5


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("moe_routing_emu"),
                         ("moe_routing",))


@pytest.fixture
def launch(emulated, monkeypatch):
    """``moe_routing._launch`` on CPU tensors, through the emulated
    library, with a fresh scratch."""
    emulate.route(monkeypatch, emulated, moe)
    monkeypatch.setattr(moe, "_WORKSPACE", {})
    return moe._launch


def _case(t, h, e, dtype, seed, policy):
    """x ~ N(0, 1) in ``dtype``, logits from a 0.02 randn router (as the
    chip's cases), the random policy's uniform draw."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, h).astype(np.float32)
    logits = x @ (0.02 * rng.randn(h, e)).astype(np.float32)
    u = rng.rand(t).astype(np.float32) if policy == "random" else None
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(logits),
            None if u is None else torch.from_numpy(u))


def _hold(launch, t, h, e, cap, k, policy, dtype, seed):
    x, logits, u = _case(t, h, e, dtype, seed, policy)
    got = launch(x, logits, u, cap, k, policy == "random")
    ref = moe.moe_route_dispatch_reference(x, logits, u, capacity=cap,
                                           top_k=k, second_policy=policy)
    for name in ("expert_index", "slot", "keep", "buf", "gate"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name != "gate":
            assert torch.equal(a, b), f"{name} differs from the plain version"
    assert float((got.gate - ref.gate).abs().max()) <= GATE_TOL
    aux, want = float(got.load_balancing_loss), \
        float(ref.load_balancing_loss)
    assert abs(aux / want - 1.0) <= AUX_RTOL, (aux, want)
    return got, ref


CASES = [
    # label, T, H, E, capacity, top_k, policy, x dtype
    ("off grain", 130, 100, 5, 33, 2, "random", F32),
    ("off grain, E > T", 33, 100, 40, 1, 2, "all", BF16),
    ("T 32, the last one-launch T", 32, 100, 5, 9, 2, "all", F32),
    ("T 33, the first two-launch T", 33, 100, 5, 9, 2, "all", F32),
    ("T 32 top1", 32, 64, 8, 5, 1, "all", BF16),
    ("T 33 top1", 33, 64, 8, 5, 1, "all", BF16),
    ("decode tick", 8, 128, 8, 8, 1, "all", BF16),
    ("decode tick, capacity 1", 8, 128, 8, 1, 1, "all", BF16),
    ("one launch, a capped grid", 20, 32, 40, 40, 2, "random", F32),
    ("2-byte words", 70, 99, 6, 16, 2, "random", BF16),
    ("one launch, 2-byte words", 12, 99, 6, 4, 1, "all", BF16),
]


@pytest.mark.parametrize("label,t,h,e,cap,k,policy,dtype", CASES,
                         ids=[c[0] for c in CASES])
def test_route_dispatch_exact(launch, label, t, h, e, cap, k, policy,
                              dtype):
    _hold(launch, t, h, e, cap, k, policy, dtype, seed=t * 7 + e)


def test_every_token_on_one_expert(launch):
    # one expert takes every first choice: its slots past the capacity
    # drop, every other expert's rows are zeros
    x = torch.from_numpy(np.random.RandomState(3).randn(40, 64)
                         .astype(np.float32))
    logits = torch.zeros(40, 6)
    logits[:, 2] = 5.0
    got = launch(x, logits, None, 16, 1, False)
    ref = moe.moe_route_dispatch_reference(x, logits, None, capacity=16)
    for name in ("expert_index", "slot", "keep", "buf"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert float((got.gate - ref.gate).abs().max()) <= GATE_TOL
    assert int(got.keep.sum()) == 16


def test_repeat_same_bits(launch):
    # the scratch kept across calls: a second call, and one at another
    # shape in between, give the same bits
    a, _ = _hold(launch, 130, 100, 5, 33, 2, "random", F32, seed=1)
    _hold(launch, 70, 16, 7, 20, 2, "all", F32, seed=2)
    b, _ = _hold(launch, 130, 100, 5, 33, 2, "random", F32, seed=1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_no_graph_without_grad():
    # the Function runs only where autograd records a grad-requiring
    # input, on either device; its outputs equal the plain call's
    x, logits, u = _case(40, 16, 4, F32, 5, "random")
    kw = dict(capacity=12, top_k=2, second_policy="random")
    plain = moe._fused(x, logits, u, **kw)
    assert plain.gate.grad_fn is None
    xx = x.clone().requires_grad_()
    graph = moe._fused(xx, logits, u, **kw)
    assert graph.buf.grad_fn is not None
    with torch.no_grad():
        assert moe._fused(xx, logits, u, **kw).buf.grad_fn is None
    for a, b in zip(plain, graph):
        assert torch.equal(a, b.detach())
