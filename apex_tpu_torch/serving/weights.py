"""Serving weights for the port: from the JAX tree, or seeded at random.

Counterpart of ``apex_tpu/serving/model.py``'s ``extract_serving_weights``.
The JAX serving forward keeps fp32 parameters and casts every matmul
kernel and embedding table to the compute dtype at each use
(``kernel.astype(dtype)``); the port casts them **once**, here, which
gives the same numbers without re-reading 345M fp32 parameters every
step.  LayerNorm gamma/beta stay fp32 (the mixed LayerNorm variant).

Dense kernels keep the Flax (in, out) layout, and the model computes
``x @ kernel + bias`` with :func:`torch.matmul` — nothing is
transposed.  The fused QKV kernel's 3H columns are ordered per head,
(h, [q|k|v], d), exactly as the JAX tree holds them.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .. import resolve_device
from .model import GPTServingWeights, LayerWeights, ServingModelConfig

__all__ = ["serving_weights_from_numpy", "init_serving_weights"]

# LayerWeights fields that stay fp32 (the mixed-dtype LayerNorm affine)
_LN_FIELDS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b")
_INIT_STD = 0.02


def _get(tree: Any, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _cast_layer(fields: dict, dtype: torch.dtype) -> LayerWeights:
    return LayerWeights(**{
        k: (v.float() if k in _LN_FIELDS else v.to(dtype))
        for k, v in fields.items()})


def _assemble(wte, wpe, layers, lnf_w, lnf_b,
              dtype: torch.dtype) -> GPTServingWeights:
    return GPTServingWeights(
        wte=wte.to(dtype), wpe=wpe.to(dtype),
        layers=tuple(_cast_layer(f, dtype) for f in layers),
        lnf_w=lnf_w.float(), lnf_b=lnf_b.float())


def serving_weights_from_numpy(tree: Any, cfg: ServingModelConfig,
                               device=None) -> GPTServingWeights:
    """The port's weights from the JAX ``GPTServingWeights`` converted
    to numpy arrays (``jax.tree.map(np.asarray, weights)``): same field
    names, read by attribute or by key; ``layers`` a sequence of
    per-layer trees.  Matmul kernels and embeddings land in
    ``cfg.dtype``, LayerNorm parameters in fp32, all on ``device``
    (cuda unless the CPU is asked for)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    layers = [{f: t(_get(lt, f)) for f in LayerWeights._fields}
              for lt in _get(tree, "layers")]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree has {len(layers)} layers, config "
                         f"{cfg.num_layers}")
    w = _assemble(t(_get(tree, "wte")), t(_get(tree, "wpe")), layers,
                  t(_get(tree, "lnf_w")), t(_get(tree, "lnf_b")),
                  cfg.dtype)
    _check_shapes(w, cfg)
    return w


def init_serving_weights(cfg: ServingModelConfig, seed: int = 0,
                         device=None, *,
                         std: float = _INIT_STD) -> GPTServingWeights:
    """Seeded random weights for a run with no checkpoint: normal(0,
    ``std``) kernels and embeddings, zero biases, unit LayerNorm gamma
    and zero beta — drawn in fp32 from one ``torch.Generator`` on
    ``device`` and cast as :func:`serving_weights_from_numpy` casts."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    hd, f = cfg.hidden_size, cfg.ffn_size

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev) * std

    def zeros(n):
        return torch.zeros(n, device=dev)

    def ones(n):
        return torch.ones(n, device=dev)

    layers = [dict(ln1_w=ones(hd), ln1_b=zeros(hd),
                   qkv_k=normal(hd, 3 * hd), qkv_b=zeros(3 * hd),
                   dense_k=normal(hd, hd), dense_b=zeros(hd),
                   ln2_w=ones(hd), ln2_b=zeros(hd),
                   fc1_k=normal(hd, f), fc1_b=zeros(f),
                   fc2_k=normal(f, hd), fc2_b=zeros(hd))
              for _ in range(cfg.num_layers)]
    w = _assemble(normal(cfg.vocab_size, hd), normal(cfg.max_seq, hd),
                  layers, ones(hd), zeros(hd), cfg.dtype)
    _check_shapes(w, cfg)
    return w


def _check_shapes(w: GPTServingWeights, cfg: ServingModelConfig,
                  ) -> None:
    hd, f = cfg.hidden_size, cfg.ffn_size
    want = dict(ln1_w=(hd,), ln1_b=(hd,), qkv_k=(hd, 3 * hd),
                qkv_b=(3 * hd,), dense_k=(hd, hd), dense_b=(hd,),
                ln2_w=(hd,), ln2_b=(hd,), fc1_k=(hd, f), fc1_b=(f,),
                fc2_k=(f, hd), fc2_b=(hd,))
    for i, lw in enumerate(w.layers):
        for name, shape in want.items():
            got = tuple(getattr(lw, name).shape)
            if got != shape:
                raise ValueError(f"layer {i} {name} is {got}, the "
                                 f"config wants {shape}")
    if tuple(w.wte.shape) != (cfg.vocab_size, hd):
        raise ValueError(f"wte {tuple(w.wte.shape)} != "
                         f"({cfg.vocab_size}, {hd})")
    if w.wpe.shape[0] < cfg.max_seq or w.wpe.shape[1] != hd:
        raise ValueError(f"wpe {tuple(w.wpe.shape)} does not cover "
                         f"max_seq {cfg.max_seq} x {hd}")

