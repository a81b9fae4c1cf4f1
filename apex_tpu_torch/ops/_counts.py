"""Launch counts of the port's kernels.

Each wrapper adds one to its kernel's count right after the launch
succeeds, and nowhere else: the plain PyTorch versions never count.
The int8-cache branches of the paged kernels count under their own
names (``flash_decode_int8``, ``flash_decode_multi_int8``), and so do
the kv_mask lanes of the E flash kernels (``flash_attention_e_kvmask``,
``flash_attention_e_bwd_kvmask``), and the E flash kernels past a padded
sequence of 1024 (``flash_attention_e_blocked``,
``flash_attention_e_bwd_blocked``: rows 11 and 13, the JAX package's
blocked walk), and the E kernels' dropout lanes, with or without a
kv_mask (``flash_attention_e_dropout``, ``flash_attention_e_bwd_dropout``
and, past a padded sequence of 1024, ``flash_attention_e_blocked_dropout``,
``flash_attention_e_bwd_blocked_dropout``), so a run can show which
branch it took.  So do the lanes of the (b, h, s, d) kernels: the
kv_mask (``flash_attention_kvmask``, ``flash_attention_bwd_kvmask``),
the partial entry's offsets and lse cotangent
(``flash_attention_partial``, ``flash_attention_partial_bwd``) and its
coordinate-hash dropout (``flash_attention_partial_dropout``,
``flash_attention_partial_bwd_dropout``), and the packed-qkv launches of
rows 7 and 9 (``flash_attention_qkv``, ``flash_attention_qkv_bwd``),
and the Adam step's launches over bf16/fp16 parameters stepped without
masters (``adam_step_lowp``, amp's O3).  A caller resets the counts just before the path it
wants to prove and reads them just after (``chip_smoke.py`` does this
around each serve and around each train step).
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("layer_norm", "flash_attention", "flash_decode",
           "flash_decode_multi", "layer_norm_bwd",
           "flash_attention_e", "flash_attention_e_bwd",
           "fused_adam_pipeline", "scaled_softmax_causal_fwd",
           "scaled_softmax_bwd", "norm_finite", "quant_gemv",
           "quant_tiled", "flash_decode_int8", "flash_decode_multi_int8",
           "scaled_masked_softmax_fwd", "flash_attention_e_kvmask",
           "flash_attention_e_bwd_kvmask", "lamb_phase1",
           "flash_attention_bwd", "flash_attention_e_blocked",
           "flash_attention_e_bwd_blocked", "moe_route_dispatch",
           "sgd_step", "sgd_pipeline", "adam_step",
           "flash_attention_e_dropout", "flash_attention_e_bwd_dropout",
           "flash_attention_e_blocked_dropout",
           "flash_attention_e_bwd_blocked_dropout", "adam_update",
           "adagrad_update", "novograd_update", "sgd_update",
           "flash_attention_kvmask", "flash_attention_bwd_kvmask",
           "flash_attention_partial", "flash_attention_partial_bwd",
           "flash_attention_partial_dropout",
           "flash_attention_partial_bwd_dropout", "flash_attention_qkv",
           "flash_attention_qkv_bwd", "adam_step_lowp")

_COUNTS: Dict[str, int] = {name: 0 for name in KERNELS}


def bump(name: str) -> None:
    _COUNTS[name] += 1


def reset_launch_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(_COUNTS)
