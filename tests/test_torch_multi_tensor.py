"""Port parity: ``apex_tpu_torch.ops.multi_tensor`` (the grouping the
optimizers' ``update`` forms lay their state out by) against
``apex_tpu.ops.multi_tensor`` on the same trees.

The JAX side takes a dict, which it flattens in sorted-key order; the port
takes the leaves as a sequence, handed over in that order.  Metadata
(groups, offsets, sizes, padded lengths, direct flags) must be equal, and
so must every buffer the copy work makes (``pack``, ``group_buffers``,
``assemble``, ``unpack_groups``, ``broadcast_per_tensor``): bitwise.
``per_tensor_sumsq`` is a reduction, summed in another order by XLA and
by PyTorch: within 1e-6 of each sum.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import multi_tensor as jmt
from apex_tpu_torch.ops import multi_tensor as tmt

TORCH = {jnp.dtype(jnp.float32): torch.float32,
         jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _tree(seed=0):
    """Keys whose sorted order differs from their insertion order; fp32
    and bf16 leaves of sizes that are not multiples of 128."""
    rng = np.random.RandomState(seed)
    spec = {"w10": ((37, 11), jnp.float32), "w2": ((300,), jnp.bfloat16),
            "bias": ((5, 129), jnp.float32), "a": ((64, 3), jnp.bfloat16),
            "z": ((2000,), jnp.float32), "m": ((7,), jnp.float32)}
    return {k: jnp.asarray(rng.randn(*s).astype(np.float32)).astype(dt)
            for k, (s, dt) in spec.items()}


def _leaves(tree):
    """The tree's leaves in JAX's flattening order, as torch tensors."""
    return [_t(x) for x in jax.tree_util.tree_leaves(tree)]


def _t(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        TORCH[jnp.dtype(x.dtype)])


def _same(got: torch.Tensor, want) -> None:
    assert got.dtype == TORCH[jnp.dtype(want.dtype)]
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def _same_metas(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.leaf_indices == w.leaf_indices
        assert g.shapes == w.shapes and g.sizes == w.sizes
        assert g.offsets == w.offsets
        assert (g.total, g.padded) == (w.total, w.padded)
        assert g.direct == w.direct
        assert g.dtype == TORCH[jnp.dtype(w.dtype)]
        assert g.n_leaves == w.treedef.num_leaves


@pytest.fixture
def direct_min(monkeypatch):
    """Set DIRECT_MIN_ELEMS in both packages (JAX's reads its flag once,
    at import; its own tests patch the constant)."""
    def set_(n):
        monkeypatch.setattr(jmt, "DIRECT_MIN_ELEMS", n)
        monkeypatch.setattr(tmt, "DIRECT_MIN_ELEMS", n)
    return set_


@pytest.mark.parametrize("raised", [False, True])
@pytest.mark.parametrize("align", [1, 128])
@pytest.mark.parametrize("split_direct", [False, True])
def test_metas_and_buffers_match_jax(split_direct, align, raised,
                                     direct_min):
    # raised: leaves under 1000 elements pack, the rest stay direct
    direct_min(1000 if raised else 0)
    tree = _tree()
    leaves = _leaves(tree)
    jm = jmt.compute_metas(tree, align=align, split_direct=split_direct)
    tm = tmt.compute_metas(leaves, align=align, split_direct=split_direct)
    _same_metas(tm, jm)
    for got, want in zip(tmt.pack(leaves, tm), jmt.pack(tree, jm)):
        _same(got, want)
    for got, want in zip(tmt.pack(leaves, tm, torch.float32),
                         jmt.pack(tree, jm, jnp.float32)):
        _same(got, want)
    tb = tmt.group_buffers(leaves, tm)
    jb = jmt.group_buffers(tree, jm)
    for got, want in zip(tb, jb):
        _same(got, want)
    assembled = tmt.assemble(tb, tm)
    for t, w in zip(assembled,
                    jax.tree_util.tree_leaves(jmt.assemble(jb, jm))):
        _same(t, w)
    for meta in tm:             # a direct leaf is never copied
        i = meta.leaf_indices[0]
        assert not meta.direct or assembled[i].data_ptr() == \
            leaves[i].data_ptr()
    zeros = tmt.state_zeros(tm, "cpu")
    for got, want in zip(zeros, jmt.state_zeros(jm)):
        _same(got, want)
    if not split_direct:
        f32 = [jnp.float32] * len(leaves)
        got = tmt.unpack_groups(tmt.pack(leaves, tm), tm,
                                [torch.float32] * len(leaves))
        want = jax.tree_util.tree_leaves(
            jmt.unpack_groups(jmt.pack(tree, jm), jm, f32))
        for t, w in zip(got, want):
            _same(t, w)


@pytest.mark.parametrize("align", [1, 128])
def test_chunk_boundary_matches_jax(align, direct_min, monkeypatch):
    """A small PACK_MAX_ELEMS: the packed leaves split into chunks at the
    same leaves in both packages."""
    direct_min(10 ** 6)
    monkeypatch.setattr(jmt, "PACK_MAX_ELEMS", 700)
    monkeypatch.setattr(tmt, "PACK_MAX_ELEMS", 700)
    tree = _tree(1)
    leaves = _leaves(tree)
    jm = jmt.compute_metas(tree, align=align, split_direct=True)
    tm = tmt.compute_metas(leaves, align=align, split_direct=True)
    _same_metas(tm, jm)
    assert len(tm) > 2          # both dtypes chunked
    for got, want in zip(tmt.group_buffers(leaves, tm),
                         jmt.group_buffers(tree, jm)):
        _same(got, want)


def test_per_tensor_sums_and_broadcast_match_jax():
    tree = _tree(2)
    leaves = _leaves(tree)
    jm = jmt.compute_metas(tree, align=jmt.LANE)
    tm = tmt.compute_metas(leaves, align=tmt.LANE)
    for jb, tb, jmeta, tmeta in zip(jmt.pack(tree, jm),
                                    tmt.pack(leaves, tm), jm, tm):
        want = np.asarray(jmt.per_tensor_sumsq(jb, jmeta))
        got = tmt.per_tensor_sumsq(tb, tmeta)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        vals = np.sqrt(want) + 0.5
        _same(tmt.broadcast_per_tensor(torch.from_numpy(vals), tmeta),
              jmt.broadcast_per_tensor(jnp.asarray(vals), jmeta))
        _same(tmt.broadcast_per_tensor(torch.from_numpy(vals), tmeta, 0.0),
              jmt.broadcast_per_tensor(jnp.asarray(vals), jmeta, 0.0))


def test_direct_buffers_are_the_leaves():
    leaves = [torch.randn(3, 5), torch.randn(7, dtype=torch.float64)]
    metas = tmt.compute_metas(leaves, split_direct=True)
    bufs = tmt.group_buffers(leaves, metas)
    assert all(b is t for b, t in zip(bufs, leaves))
    assert [m.direct for m in metas] == [True, True]
