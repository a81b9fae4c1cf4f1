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

A JAX Q8 tree (``QuantGPTServingWeights``) carries across as the port's
:class:`~apex_tpu_torch.ops.quant_matmul.QuantGPTServingWeights`: its
int8 codes and fp32 scales kept as they are, the rest cast as above, so
a Q8 model computes in the port what it computes in JAX.

A JAX tree with MoE layers (``MoELayerWeights``: a router and expert
stacks in place of fc1/fc2) carries across layer by layer: the router
stays fp32 (routing is argmax over its logits), the expert stacks land in
the compute dtype.  MoE layers have no Q8 layout (the int8 kernels take
no expert stacks), as in JAX.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..ops.quant_matmul import (QUANTIZED, QuantGPTServingWeights,
                                QuantLayerWeights)
from .model import (GPTServingWeights, LayerWeights, MoELayerWeights,
                    ServingModelConfig)

__all__ = ["serving_weights_from_numpy", "init_serving_weights",
           "check_serving_weights"]

# layer fields that stay fp32: the mixed-dtype LayerNorm affine and an MoE
# layer's router
_FP32_FIELDS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "router")
_INIT_STD = 0.02


def _get(tree: Any, name: str):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _has(tree: Any, name: str) -> bool:
    return name in tree if isinstance(tree, Mapping) else hasattr(tree,
                                                                  name)


# a Q8 layer's int8 codes and fp32 scales, carried across as they are
_Q8_FIELDS = tuple(f"{n}_{s}" for n in QUANTIZED for s in "ks")


def _layer_type(has) -> type:
    """The port's tree for a layer; ``has(name)`` tells its fields."""
    return QuantLayerWeights if has("qkv_s") else \
        MoELayerWeights if has("router") else LayerWeights


def _cast_layer(fields: dict, dtype: torch.dtype):
    keep = _Q8_FIELDS if "qkv_s" in fields else ()
    return _layer_type(fields.__contains__)(**{
        k: (v if k in keep else v.float() if k in _FP32_FIELDS
            else v.to(dtype))
        for k, v in fields.items()})


def _assemble(wte, wpe, layers, lnf_w, lnf_b, dtype: torch.dtype):
    tree = QuantGPTServingWeights if layers and "qkv_s" in layers[0] \
        else GPTServingWeights
    return tree(
        wte=wte.to(dtype), wpe=wpe.to(dtype),
        layers=tuple(_cast_layer(f, dtype) for f in layers),
        lnf_w=lnf_w.float(), lnf_b=lnf_b.float())


def serving_weights_from_numpy(tree: Any, cfg: ServingModelConfig,
                               device=None) -> GPTServingWeights:
    """The port's weights from the JAX ``GPTServingWeights`` (or its Q8
    ``QuantGPTServingWeights``) converted to numpy arrays
    (``jax.tree.map(np.asarray, weights)``): same field names, read by
    attribute or by key; ``layers`` a sequence of per-layer trees.
    Matmul kernels and embeddings land in ``cfg.dtype``, LayerNorm
    parameters in fp32, a Q8 tree's int8 codes and fp32 scales as they
    are, all on ``device`` (cuda unless the CPU is asked for)."""
    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        a = np.array(a, dtype=np.int8 if a.dtype == np.int8 else np.float32)
        return torch.from_numpy(a).to(dev)

    layer_trees = list(_get(tree, "layers"))
    layers = [{f: t(_get(lt, f)) for f in _layer_type(
        lambda n, lt=lt: _has(lt, n))._fields} for lt in layer_trees]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree has {len(layers)} layers, config "
                         f"{cfg.num_layers}")
    w = _assemble(t(_get(tree, "wte")), t(_get(tree, "wpe")), layers,
                  t(_get(tree, "lnf_w")), t(_get(tree, "lnf_b")),
                  cfg.dtype)
    check_serving_weights(w, cfg)
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
    check_serving_weights(w, cfg)
    return w


def check_serving_weights(w, cfg: ServingModelConfig) -> None:
    """Raise unless ``w`` has ``cfg``'s shapes; for a Q8 tree, int8 codes
    with one fp32 scale per output column; for an MoE layer, an fp32 (H,
    E) router and (E, H, F) / (E, F, H) expert stacks with E =
    ``cfg.num_experts``."""
    hd, f, e = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    attn = dict(ln1_w=(hd,), ln1_b=(hd,), qkv_k=(hd, 3 * hd),
                qkv_b=(3 * hd,), dense_k=(hd, hd), dense_b=(hd,),
                ln2_w=(hd,), ln2_b=(hd,))
    dense = dict(attn, fc1_k=(hd, f), fc1_b=(f,), fc2_k=(f, hd),
                 fc2_b=(hd,))
    moe = dict(attn, router=(hd, e), wi=(e, hd, f), wo=(e, f, hd))
    for i, lw in enumerate(w.layers):
        is_moe = hasattr(lw, "router")
        if is_moe and lw.router.dtype != torch.float32:
            raise ValueError(f"layer {i} router is {lw.router.dtype}; "
                             f"routing needs fp32")
        for name, shape in (moe if is_moe else dense).items():
            got = tuple(getattr(lw, name).shape)
            if got != shape:
                raise ValueError(f"layer {i} {name} is {got}, the "
                                 f"config wants {shape}")
        for name in QUANTIZED if hasattr(lw, "qkv_s") else ():
            k, s = getattr(lw, f"{name}_k"), getattr(lw, f"{name}_s")
            if k.dtype != torch.int8 or s.dtype != torch.float32 \
                    or tuple(s.shape) != (k.shape[1],):
                raise ValueError(f"layer {i} {name}: int8 codes {k.dtype} "
                                 f"with fp32 scales {s.dtype} "
                                 f"{tuple(s.shape)} expected")
    if tuple(w.wte.shape) != (cfg.vocab_size, hd):
        raise ValueError(f"wte {tuple(w.wte.shape)} != "
                         f"({cfg.vocab_size}, {hd})")
    if w.wpe.shape[0] < cfg.max_seq or w.wpe.shape[1] != hd:
        raise ValueError(f"wpe {tuple(w.wpe.shape)} does not cover "
                         f"max_seq {cfg.max_seq} x {hd}")

