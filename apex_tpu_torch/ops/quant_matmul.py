"""int8 weight-only matmul (the Q8 serving tier): the CUDA kernels and
their plain version.

Port of ``apex_tpu/ops/quant_matmul.py``.  Every layer matmul weight of
a Q8 model is stored as **per-output-channel symmetric int8** with one
fp32 scale per output column: ``scale = max(amax, 1e-8) / 127`` and
``codes = clip(round(w / scale), -127, 127)``, the floor making an
all-zero column round-trip to exact zeros.  :func:`quant_matmul`
computes ``x @ (wq * scale)`` without building ``wq * scale``: the
products against the raw codes accumulate in fp32 and the column scale
multiplies the accumulated sum once (it distributes over the
contraction), then the result is cast to the out dtype.

The dispatch is JAX's: with M the product of x's leading dimensions,
M <= 8 runs the GEMV kernel (``_quant_gemv``, row 16: every decode
linear), anything larger the tiled kernel (``_quant_tiled``, row 17:
prefill, verify and chunk linears), both in ``csrc/quant_matmul.cu``.
On a CUDA tensor :func:`quant_matmul` launches one of them or raises;
on a CPU tensor it runs :func:`quant_matmul_reference`, an fp32 matmul
on the codes with the scale applied after.

Inference only: no autograd Function (quantized weights are a
deployment artifact, never differentiated through).

The Q8 model trees (:class:`QuantLayerWeights`,
:class:`QuantGPTServingWeights`) and :func:`quantize_weights`, the
offline conversion of a float serving tree, live here as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from ._counts import bump

__all__ = ["SCALE_FLOOR", "GEMV_MAX_ROWS", "quantize_weight",
           "dequantize_weight", "quant_matmul", "quant_matmul_reference",
           "QuantLayerWeights", "QuantGPTServingWeights",
           "quantize_weights", "is_quantized_weights"]

# an all-zero output channel gets scale 1e-8 / 127: codes 0, and 0 back
SCALE_FLOOR = 1e-8
# M <= this many rows runs the GEMV kernel, more the tiled kernel
GEMV_MAX_ROWS = 8

_X_TAKES = (torch.float32, torch.bfloat16, torch.float16)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float weight -> ``(wq int8 (K, N), scale fp32 (N,))``,
    symmetric per output column: ``w ~= wq * scale``.  Round half to
    even, as ``jnp.round``."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weight expects (K, N), got "
                         f"{tuple(w.shape)}")
    wf = w.float()
    scale = wf.abs().amax(dim=0).clamp(min=SCALE_FLOOR) / 127.0
    wq = torch.round(wf / scale).clamp(-127.0, 127.0).to(torch.int8)
    return wq, scale


def dequantize_weight(wq: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``wq * scale`` as a dense float weight (tests and yardsticks; the
    serving math never builds it)."""
    return (wq.float() * scale.float()[None, :]).to(dtype)


def quant_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor, *,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """Plain version: an fp32 matmul against the codes, the per-column
    scale applied after the contraction, cast to ``out_dtype`` (x's
    dtype by default)."""
    out_dtype = out_dtype or x.dtype
    acc = torch.matmul(x.float(), wq.float())
    return (acc * scale.float()).to(out_dtype)


def _check(x, wq, scale):
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8, got {wq.dtype}")
    if wq.dim() != 2 or scale.dim() != 1 or scale.shape[0] != wq.shape[1]:
        raise ValueError(f"wq (K, N) / scale (N,) mismatch: "
                         f"{tuple(wq.shape)} vs {tuple(scale.shape)}")
    if x.shape[-1] != wq.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs wq "
                         f"{tuple(wq.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_matmul runs on cuda or cpu, not "
                         f"{x.device}")


def _launch(x2, wq, scale, out_dtype):
    """The kernel for ``x2`` (M, K) on the card: the GEMV at M <= 8, the
    tiled kernel above."""
    if x2.dtype not in _X_TAKES:
        raise TypeError(f"quant_matmul kernel takes x in {_X_TAKES}, got "
                        f"{x2.dtype}")
    if out_dtype not in (x2.dtype, torch.float32):
        raise TypeError(f"quant_matmul kernel writes x's dtype or fp32, "
                        f"not {out_dtype} for x {x2.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be fp32, got {scale.dtype}")
    for name, t in (("wq", wq), ("scale", scale)):
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x2.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    gemv = m <= GEMV_MAX_ROWS
    lib = _build.library("quant_matmul")
    fn = lib.apex_quant_gemv if gemv else lib.apex_quant_tiled
    with torch.cuda.device(x2.device):
        rc = fn(x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                out.data_ptr(), m, n, k, _build.dtype_code(x2.dtype),
                _build.dtype_code(out_dtype), _build.stream_ptr(x2.device))
    name = "quant_gemv" if gemv else "quant_tiled"
    _build.check("quant_matmul", rc, f"{name} kernel")
    bump(name)
    return out


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ (wq * scale)`` with fp32 accumulation: ``x`` (..., K) float,
    ``wq`` (K, N) int8, ``scale`` (N,) fp32; returns (..., N) in
    ``out_dtype`` (x's dtype by default).  M (the product of x's leading
    dimensions) <= 8 takes the GEMV kernel, more the tiled kernel; on a
    CPU tensor the plain version."""
    _check(x, wq, scale)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_reference(x, wq, scale, out_dtype=out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    return _launch(x2, wq, scale, out_dtype).reshape(*lead, wq.shape[1])


class QuantLayerWeights(NamedTuple):
    """One transformer layer with int8 matmul kernels and their
    per-column scales: :class:`~apex_tpu_torch.serving.model.LayerWeights`
    with a ``*_s`` after each quantized kernel, as in JAX — the serving
    steps pick the int8 path by ``getattr(lw, "qkv_s", None)``."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_k: torch.Tensor       # (H, 3H) int8
    qkv_s: torch.Tensor       # (3H,) fp32
    qkv_b: torch.Tensor
    dense_k: torch.Tensor     # (H, H) int8
    dense_s: torch.Tensor     # (H,) fp32
    dense_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_k: torch.Tensor       # (H, F) int8
    fc1_s: torch.Tensor       # (F,) fp32
    fc1_b: torch.Tensor
    fc2_k: torch.Tensor       # (F, H) int8
    fc2_s: torch.Tensor       # (H,) fp32
    fc2_b: torch.Tensor


class QuantGPTServingWeights(NamedTuple):
    """The Q8 model: layer matmuls int8; embeddings, LayerNorms, biases
    and the tied LM head as they were."""

    wte: torch.Tensor
    wpe: torch.Tensor
    layers: Tuple[QuantLayerWeights, ...]
    lnf_w: torch.Tensor
    lnf_b: torch.Tensor


QUANTIZED = ("qkv", "dense", "fc1", "fc2")


def quantize_weights(weights) -> QuantGPTServingWeights:
    """A float serving tree (:class:`~apex_tpu_torch.serving.model.
    GPTServingWeights`-shaped) -> the Q8 tree, each layer matmul weight
    quantized as it is held (the port's trees hold the policy-cast
    weights)."""
    layers = []
    for lw in weights.layers:
        if hasattr(lw, "router"):
            raise ValueError("MoE layers have no Q8 layout: the int8 "
                             "kernels take no expert stacks")
        fields = lw._asdict()
        for name in QUANTIZED:
            fields[f"{name}_k"], fields[f"{name}_s"] = \
                quantize_weight(fields[f"{name}_k"])
        layers.append(QuantLayerWeights(**fields))
    return QuantGPTServingWeights(
        wte=weights.wte, wpe=weights.wpe, layers=tuple(layers),
        lnf_w=weights.lnf_w, lnf_b=weights.lnf_b)


def is_quantized_weights(weights) -> bool:
    """True when ``weights`` carries int8 matmul kernels."""
    layers = getattr(weights, "layers", ())
    return bool(layers) and hasattr(layers[0], "qkv_s")
