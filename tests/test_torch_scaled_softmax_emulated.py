"""Row 5's padding-mask softmax forward (``masked_fwd_kernel`` in
``apex_tpu_torch/csrc/scaled_softmax.cu``) runs on the CPU and is held
against its plain version, ``masked_softmax_reference``.

The source is built with g++ over ``tests/cuda_emu`` (``emulate.py``: one
host thread a CUDA thread, warp shuffles through a table of the warp's
lanes).  The kernels' own code runs, by the launcher's routes: 16-byte
loads of scores (8 fp16 / bf16 or 4 fp32 a lane) with the matching mask
bytes, every load of a row issued before its max, the row in registers
(sk = 512, and sk = 200, which leaves lanes idle); the element path where
sk is off the vector width or x sits off its 16-byte alignment (sk = 98);
the looped two-pass variant past 1024 columns (sk = 1280, 1030); one mask
plane shared by every batch row (``mask_sb`` 0).

The holds are ``chip_smoke.py``'s ``check_masked_softmax``: the dtype's
tolerance against the plain version (fp32 ``SOFTMAX_TOL`` 1e-6, fp16
``SOFTMAX_FP16_TOL`` 1e-3, bf16 one ulp of the values below 1, 2^-8, as
``test_torch_scaled_softmax.py`` holds bf16), everything finite, a fully
masked row exactly 1/sk (the fp32 quotient in the output dtype), the
masked keys of a live row exactly 0.  The 16-byte path adds each row's exps in the element path's order,
so the two paths agree bit for bit (held at sk = 512 and 200); it divides
by the row's sum through its reciprocal with Markstein's correction
(``div_by``), which the last test holds to IEEE division bit for bit over
the kernel's range of quotients.
"""
import importlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from cuda_emu import emulate

ss = importlib.import_module("apex_tpu_torch.ops.scaled_softmax")

F32, F16, BF16 = torch.float32, torch.float16, torch.bfloat16
TOL = {F32: 1e-6, F16: 1e-3, BF16: 2.0 ** -8}
SCALE = 0.125


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return emulate.build(tmp_path_factory.mktemp("scaled_softmax_emu"),
                         ("scaled_softmax",))


@pytest.fixture
def launch(emulated, monkeypatch):
    """``scaled_softmax._launch_masked`` on CPU tensors, through the
    emulated library."""
    emulate.route(monkeypatch, emulated, ss)
    return ss._launch_masked


def _case(b, np_, sq, sk, dtype, seed, mask_b=None):
    """Scores of 3 sigma and a 30 % random mask with query row 1 of the
    first plane fully masked and the last plane's last 3 keys padded."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(3 * rng.randn(b, np_, sq, sk).astype(np.float32))
    mask = torch.from_numpy(rng.rand(mask_b or b, 1, sq, sk) < 0.3)
    mask[0, 0, 1, :] = True
    mask[-1, 0, :, -3:] = True
    return x.to(dtype), mask


def _run(launch, x, mask):
    y = launch(x, mask, SCALE)
    want = ss.masked_softmax_reference(x, mask, SCALE)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.isfinite(y).all(), "not finite"
    err = float((y.float() - want.float()).abs().max())
    assert err <= TOL[x.dtype], f"max_abs_err {err:.3e}"
    masked = mask.expand_as(x)
    dead = masked.all(-1, keepdim=True).expand_as(x)
    sk = x.shape[-1]
    uniform = torch.tensor(1.0 / sk, dtype=F32).to(x.dtype)
    assert dead.any() and (y[dead] == uniform).all(), \
        "a fully masked row is not exactly 1/sk"
    assert (y[masked & ~dead] == 0).all(), \
        "a masked key of a live row is not exactly 0"
    return y


@pytest.mark.parametrize("dtype", [F32, F16, BF16])
@pytest.mark.parametrize("sk", [512, 200, 98, 1280, 1030])
def test_masked_forward_routes(launch, sk, dtype):
    # 3 x 3 heads x 5 query rows: 45 rows, the last block's warps past
    # the end
    x, mask = _case(3, 3, 5, sk, dtype, seed=sk)
    _run(launch, x, mask)


@pytest.mark.parametrize("dtype", [F32, F16, BF16])
def test_one_mask_plane_for_every_batch(launch, dtype):
    # a (1, 1, sq, sk) mask: mask_sb 0, the plane read by every batch row
    x, mask = _case(3, 2, 4, 512, dtype, seed=3, mask_b=1)
    _run(launch, x, mask)


@pytest.mark.parametrize("dtype", [F32, F16, BF16])
@pytest.mark.parametrize("sk", [512, 200])
def test_misaligned_scores(launch, sk, dtype):
    # x one element past a 16-byte boundary takes the element path, whose
    # output the 16-byte path's must equal bit for bit (the same max, exps
    # and sum order; quotients here all far above 2^-100)
    x, mask = _case(2, 2, 4, sk, dtype, seed=4)
    buf = torch.empty(x.numel() + 1, dtype=dtype)[1:].view_as(x)
    y_elem = _run(launch, buf.copy_(x), mask)
    assert torch.equal(_run(launch, x, mask), y_elem), \
        "the 16-byte path differs from the element path"


def test_repeat_is_bitwise(launch):
    x, mask = _case(2, 3, 5, 512, F16, seed=5)
    assert torch.equal(_run(launch, x, mask), launch(x, mask, SCALE)), \
        "a second call gave other bits"


# div_by(a, b, 1 / b) against a / b: exp(-gap) numerators, gap in [0,
# 110) (every seventh 1, a fully masked row's), sums in [1, 1024] (every
# eleventh an integer, a fully masked row's sk); prints the pairs that
# differ with a >= 2^-100 and those below it off by more than one ulp
_DIVISION_CHECK = r"""
#include <random>
int main() {
  std::mt19937_64 rng(18);
  long long normal = 0, tiny = 0;
  for (int it = 0; it < 4000000; ++it) {
    float a = expf(-std::uniform_real_distribution<float>(0.f, 110.f)(rng));
    if (it % 7 == 0) a = 1.f;
    float b = it % 11 == 0 ? (float)(1 + rng() % 1024)
                           : std::uniform_real_distribution<float>(1.f, 1024.f)(rng);
    volatile float r = 1.f / b, ieee = a / b;
    const float got = div_by(a, b, r), want = ieee;
    if (got == want) continue;
    if (a >= 0x1p-100f) ++normal;
    else if (got != nextafterf(want, 0.f) && got != nextafterf(want, 1.f)) ++tiny;
  }
  printf("%lld %lld\n", normal, tiny);
}
"""


def test_division_is_ieee(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's division for the CPU")
    src = emulate.host_source((_build.CSRC / "scaled_softmax.cu").read_text())
    (tmp_path / "div.cc").write_text(src + _DIVISION_CHECK)
    subprocess.run([gxx, "-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off",
                    "-fno-strict-aliasing", "-pthread", "-w",
                    f"-I{emulate.EMU}", "-include",
                    str(emulate.EMU / "warp_prims.h"), str(tmp_path / "div.cc"),
                    "-o", str(tmp_path / "div")], check=True)
    out = subprocess.run([str(tmp_path / "div")], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["0", "0"], \
        f"div_by differs from IEEE division: {out[0]} pairs with a >= " \
        f"2^-100, {out[1]} below it by more than one ulp"
