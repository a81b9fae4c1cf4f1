"""The fused multi-head attention module family (parity with
``apex/contrib/multihead_attn``), ported from
``apex_tpu/contrib/multihead_attn``: the reference's eight variants as
module options over one core, the flash kernels (with their kv_mask and
dropout lanes) or the softmax kernels.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .encdec_multihead_attn import EncdecMultiheadAttn
from .functional import attn_core, attn_core_qkv, mask_softmax_dropout
from .self_multihead_attn import SelfMultiheadAttn

__all__ = ["SelfMultiheadAttn", "EncdecMultiheadAttn", "attn_core",
           "attn_core_qkv", "mask_softmax_dropout",
           "multihead_params_from_numpy"]


def multihead_params_from_numpy(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax MHA module's ``params`` (nested dicts of arrays) as a state
    dict of the port's module: the names join with ".", the arrays
    carried as they are (the flax weights are (out, in) already), in
    fp32; ``load_state_dict`` casts them to the module's dtype."""
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = torch.from_numpy(
                    np.array(val, dtype=np.float32, copy=True))

    walk(params, "")
    return out
