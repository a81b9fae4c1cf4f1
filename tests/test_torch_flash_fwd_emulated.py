"""The flash forward's tensor-core kernel (rows 6, 7, 10, 11 and the
partial's forward: ``mma_fwd_kernel`` in ``apex_tpu_torch/csrc/
flash_fwd.cuh``, instantiated by ``flash_attention.cu`` and
``flash_attention_partial.cu``) runs on the CPU and is held against its
plain versions, ``mha_reference`` and the partial's reference.

The sources are built with g++ over ``tests/cuda_emu`` (``emulate.py``,
shared with ``test_torch_flash_bwd_emulated.py``): one host thread a CUDA
thread, ``ldmatrix``, ``cp.async`` and ``mma.sync.m16n8k16`` with the PTX
ISA's fragment layouts.  The kernel's own code runs: the 64-key walk and
its causal end, the kv_mask's tile skip, every lane's predicate (causal,
offsets, kv_mask, both dropout hashes), the online softmax across the
quad, the hi + lo split of P and the ragged edges.  What the card adds
(timing, the hardware's sum order, ``exp2f``'s last bits) is held on the
card by ``chip_smoke.py``.

The hold is ``chip_smoke.py``'s ``_hold_forward``, at the operand's ulp:
each o element within one ulp of the operand dtype (2^-7 of the
reference in bf16, 2^-10 in fp16) plus ``O_ATOL``, the fp32 lse within
``LSE_TOL`` where it is finite and -inf on the same rows.  Shapes are
small (a block's 128 threads are 128 host threads) and cross the tile
edges: 64-row blocks, 64-key walked tiles.
"""
import importlib
import math

import numpy as np
import pytest
import torch

from cuda_emu import emulate

fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

ULP_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
O_ATOL = 1e-5
LSE_TOL = 1e-3
DTYPES = (torch.bfloat16, torch.float16)
LIBS = ("flash_attention", "flash_attention_partial")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("flash_fwd_emu"), LIBS)


@pytest.fixture
def launch(emulated, monkeypatch):
    """``flash_attention._launch`` on CPU tensors, through the emulated
    libraries."""
    emulate.route(monkeypatch, emulated, fa)
    return fa._launch


def _randn(rng, *shape, dtype):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _tile_drop(rate, seed, width):
    return fa._Drop(rate, fa._seed31(seed), width, fa._threshold(rate),
                    1.0 / (1.0 - rate))


def _hold(o, lse, o_r, lse_r):
    assert torch.isfinite(o).all(), "o not finite"
    excess = float(((o.float() - o_r.float()).abs()
                    - ULP_RTOL[o.dtype] * o_r.float().abs()).max())
    assert excess <= O_ATOL, f"o: {excess:.3e} past the hold"
    live = torch.isfinite(lse_r)
    assert torch.equal(torch.isfinite(lse), live), "dead rows differ"
    lerr = float((lse[live] - lse_r[live]).abs().max()) if live.any() else 0.
    assert lerr <= LSE_TOL, f"lse: {lerr:.3e} past the hold"


def _run(launch, b, h, sq, sk, d, causal, dtype=torch.bfloat16,
         kv_mask=None, drop=None, diag=None, seed=0):
    rng = np.random.RandomState(seed)
    q = _randn(rng, b, h, sq, d, dtype=dtype)
    k, v = (_randn(rng, b, h, sk, d, dtype=dtype) for _ in "kv")
    scale = d ** -0.5
    if diag is None:
        want = fa.mha_reference(q, k, v, scale=scale, causal=causal,
                                return_lse=True, kv_mask=kv_mask,
                                **fa._ref_drop(drop, b, h, sq, sk, "cpu"))
    else:
        want = fa._partial_forward_reference(q, k, v, scale, causal, diag,
                                             drop)
    o, lse = launch(q, k, v, scale, causal, "emulated", kv_mask=kv_mask,
                    drop=drop, diag=diag)
    _hold(o, lse, *want)
    return o, lse


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq,sk,d,causal", [
    (200, 200, 64, True), (130, 200, 64, False), (200, 130, 64, True),
    (100, 170, 128, True), (170, 100, 128, False)])
def test_lanes_free_of_masks(launch, dtype, sq, sk, d, causal):
    _run(launch, 1, 2 if d == 64 else 1, sq, sk, d, causal, dtype)


@pytest.mark.parametrize("d", (64, 128))
def test_kv_mask_lane(launch, d):
    kvm = torch.ones(3, 200)
    kvm[0, 150:] = 0
    kvm[1] = 0              # a batch row that attends nothing
    kvm[2, 64:128] = 0      # a whole walked tile masked
    kvm[2, 190:] = 0
    o, lse = _run(launch, 3, 1, 200, 200, d, False, kv_mask=kvm)
    assert not o[1].any() and bool((lse[1] == -math.inf).all())


@pytest.mark.parametrize("d,s,width,causal,kv", [
    (64, 200, 256, True, False), (64, 300, 128, True, False),
    (128, 200, 128, False, False), (64, 200, 256, False, True)])
def test_tile_hash_dropout_lane(launch, d, s, width, causal, kv):
    kvm = None
    if kv:
        kvm = torch.ones(2, s)
        kvm[0, 120:] = 0
    _run(launch, 2 if kv else 1, 1, s, s, d, causal, kv_mask=kvm,
         drop=_tile_drop(0.1, 7 + width, width))


def test_tile_hash_width_contract(launch):
    # W = 96 would straddle two hash tiles inside a 64-key walked tile:
    # the C entry refuses it below the sequence, takes it at or above
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(launch, 1, 1, 200, 200, 64, True, drop=_tile_drop(0.1, 5, 96))
    _run(launch, 1, 1, 96, 96, 64, True, drop=_tile_drop(0.1, 5, 96))


# sq = 130, sk = 200: diag 200 leaves every key in the past, -130 every
# key in the future (each row dead, JAX's finite lse)
@pytest.mark.parametrize("dropout", (False, True))
@pytest.mark.parametrize("diag", (0, 70, -50, 150, 200, -130))
def test_partial_offsets(launch, diag, dropout):
    drop = fa._partial_drop(0.1, 11, 100, 30, 3) if dropout else None
    o, lse = _run(launch, 1, 2, 130, 200, 64, True, diag=diag, drop=drop)
    if diag == -130:
        assert not o.any()
        assert bool((lse == fa._dead_lse(64 ** -0.5)).all())


@pytest.mark.parametrize("causal,diag,d", [(True, 40, 128), (False, 0, 64)])
def test_partial_lanes(launch, causal, diag, d):
    _run(launch, 1, 1, 130, 150, d, causal, dtype=torch.float16, diag=diag,
         drop=fa._partial_drop(0.1, 13, 7, 0, 2))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float16, 128)])
def test_e_layout_views(launch, dtype, d):
    # the heads' [q|k|v] lanes of one (b, s, h, 3d) qkv, read in place
    b, s, h = 2, 140, 2
    qkv = _randn(np.random.RandomState(3), b, s, h, 3 * d, dtype=dtype)
    q, k, v = fa._split_e(qkv)
    o, lse = launch(q, k, v, d ** -0.5, True, "emulated")
    _hold(o, lse, *fa.mha_reference(q, k, v, causal=True, return_lse=True))


def test_misaligned_views_are_copied(launch):
    # q's rows start off 16 bytes: the wrapper copies it, the launch holds
    b, h, s, d = 1, 1, 100, 64
    rng = np.random.RandomState(4)
    base = _randn(rng, b, h, s * d + 4, dtype=torch.bfloat16)
    q = base[..., 4:].view(b, h, s, d)
    assert not fa._rows16(q)
    k, v = (_randn(rng, b, h, s, d, dtype=torch.bfloat16) for _ in "kv")
    o, lse = launch(q, k, v, d ** -0.5, True, "emulated")
    _hold(o, lse, *fa.mha_reference(q, k, v, causal=True, return_lse=True))
