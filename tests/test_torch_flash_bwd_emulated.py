"""The flash backward's CUDA kernels (rows 8, 9, 12, 13 and the
partial's: ``apex_tpu_torch/csrc/flash_attention_bwd.cu`` and
``flash_attention_partial.cu`` over ``flash_bwd.cuh``) run on the CPU and
held against their plain version, ``flash_attention_backward_reference``.

There is no card here, so the sources are built with g++ against
``tests/cuda_emu`` (``emulate.py``): a CPU stand-in of the CUDA runtime
(one host thread a CUDA thread, barriers for ``__syncthreads`` and the
warp collectives) and of the warp-level primitives the tensor-core passes use (``ldmatrix``,
``cp.async``, ``mma.sync.m16n8k16`` with the PTX ISA's fragment
layouts).  The kernels' own code runs: the tile walks, the fragment
index math, every lane's predicate (causal, offsets, kv_mask, both
dropout hashes, the lse cotangent), the hi + lo operand split and the
ragged edges.  What the card adds (timing, the hardware's sum order,
``exp2f``'s last bits) is held on the card by ``chip_smoke.py``.

The hold is ``chip_smoke.py``'s: each gradient element within one bf16
ulp of the reference plus ``DQKV_ATOL``.  Shapes are small (a block's
128 threads are 128 host threads) and cross the tile edges: 64-row
blocks, 64-row walked tiles (32 at d = 128 in dK/dV).
"""
import importlib

import pytest
import torch

from cuda_emu import emulate

fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")

DQKV_ULP_RTOL = 2.0 ** -7
DQKV_ATOL = 1e-5
LIBS = ("flash_attention_bwd", "flash_attention_partial")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("flash_bwd_emu"), LIBS)


@pytest.fixture
def launch(emulated, monkeypatch):
    """``flash_attention._launch_backward`` on CPU tensors, through the
    emulated libraries."""
    emulate.route(monkeypatch, emulated, fa)
    return fa._launch_backward


def _tile_drop(rate, seed, width):
    return fa._Drop(rate, fa._seed31(seed), width, fa._threshold(rate),
                    1.0 / (1.0 - rate))


def _run(launch, b, h, sq, sk, d, causal, dtype=torch.bfloat16,
         kv_mask=None, drop=None, diag=None, dlse=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, sq, d, generator=g).to(dtype)
    k, v = (torch.randn(b, h, sk, d, generator=g).to(dtype) for _ in "kv")
    do = torch.randn(b, h, sq, d, generator=g).to(dtype)
    scale = d ** -0.5
    ref_drop = fa._ref_drop(drop, b, h, sq, sk, "cpu")
    if diag is None:
        o, lse = fa.mha_reference(q, k, v, scale=scale, causal=causal,
                                  return_lse=True, kv_mask=kv_mask,
                                  **ref_drop)
        offsets = {}
    else:
        o, lse = fa._partial_forward_reference(q, k, v, scale, causal, diag,
                                               drop)
        offsets = dict(q_offset=diag)
    dl = torch.randn(b, h, sq, generator=g) if dlse else None
    want = fa.flash_attention_backward_reference(
        q, k, v, o, lse, do, scale=scale, causal=causal, kv_mask=kv_mask,
        dlse=dl, **offsets, **ref_drop)
    got = [torch.full(t.shape, float("nan"), dtype=dtype) for t in (q, k, v)]
    launch(q, k, v, o, lse, do, *got, scale, causal, "emulated",
           kv_mask=kv_mask, drop=drop, diag=diag, dlse=dl)
    for name, a, w in zip("qkv", got, want):
        assert torch.isfinite(a).all(), f"d{name} not finite"
        excess = float(((a.float() - w.float()).abs()
                        - DQKV_ULP_RTOL * w.float().abs()).max())
        assert excess <= DQKV_ATOL, f"d{name}: {excess:.3e} past the hold"
    return got


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16,
                                   torch.float32))
@pytest.mark.parametrize("sq,sk,d,causal", [
    (200, 200, 64, True), (130, 200, 64, False), (100, 170, 128, True),
    (170, 100, 128, False)])
def test_lanes_free_of_masks(launch, dtype, sq, sk, d, causal):
    _run(launch, 1, 2 if d == 64 else 1, sq, sk, d, causal, dtype)


@pytest.mark.parametrize("d", (64, 128))
def test_kv_mask_lane(launch, d):
    kvm = torch.ones(3, 200)
    kvm[0, 150:] = 0
    kvm[1] = 0              # a batch row that attends nothing
    kvm[2, 64:128] = 0      # a whole 64-key block and walked tile masked
    kvm[2, 190:] = 0
    got = _run(launch, 3, 1, 200, 200, d, False, kv_mask=kvm)
    assert all(not t[1].any() for t in got)
    assert not got[1][2, :, 64:128].any() and not got[2][2, :, 64:128].any()


@pytest.mark.parametrize("d,s,width,kv", [
    (64, 200, 256, False), (64, 300, 128, False), (128, 200, 128, False),
    (64, 200, 256, True)])
def test_tile_hash_dropout_lane(launch, d, s, width, kv):
    kvm = None
    if kv:
        kvm = torch.ones(2, s)
        kvm[0, 120:] = 0
    _run(launch, 2 if kv else 1, 1, s, s, d, not kv, kv_mask=kvm,
         drop=_tile_drop(0.1, 7 + width, width))


@pytest.mark.parametrize("diag,d", [(0, 64), (70, 64), (-50, 64),
                                    (150, 64), (40, 128)])
def test_partial_offsets_and_lse_cotangent(launch, diag, d):
    _run(launch, 1, 2 if d == 64 else 1, 130, 150, d, True, diag=diag,
         dlse=True)


@pytest.mark.parametrize("causal,diag", [(True, 70), (False, 0)])
def test_partial_coordinate_hash_dropout(launch, causal, diag):
    drop = fa._partial_drop(0.1, 11, 100, 30, 3)
    _run(launch, 1, 2, 130, 150, 64, causal, diag=diag, dlse=causal,
         drop=drop)


def test_misaligned_views_are_copied(launch):
    # a view whose rows start off 16 bytes: the wrapper copies it, the
    # launch holds
    b, h, s, d = 1, 1, 64, 64
    base = torch.randn(b, h, s * d + 4).bfloat16()
    q = base[..., 4:].view(b, h, s, d)
    assert not fa._rows16(q)
    k, v, do = (torch.randn(b, h, s, d).bfloat16() for _ in "kvo")
    o, lse = fa.mha_reference(q, k, v, causal=True, return_lse=True)
    want = fa.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                 causal=True)
    got = [torch.empty_like(t) for t in (q, k, v)]
    launch(q, k, v, o, lse, do, *got, d ** -0.5, True, "emulated")
    for a, w in zip(got, want):
        assert float(((a.float() - w.float()).abs()
                      - DQKV_ULP_RTOL * w.float().abs()).max()) <= DQKV_ATOL
