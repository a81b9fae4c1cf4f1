"""Precision policies: the O0–O5 opt levels as data, with torch dtypes.

Port of ``apex_tpu/amp/policy.py``.  A policy is an immutable dataclass;
the serving slice reads only ``cast_model_type`` (O5 -> bfloat16), the
training slice will read the rest.

=====  ===========  ============  ==========  =======  ===========
level  cast_model   autocast ops  keep_bn32   masters  loss_scale
=====  ===========  ============  ==========  =======  ===========
O0     —            —             (fp32)      no       1.0
O1     —            fp16 lists    yes         no       dynamic
O2     fp16         —             yes         yes      dynamic
O3     fp16         —             no          no       1.0
O4     —            bf16 lists    yes         no       1.0
O5     bf16         —             yes         yes      1.0
=====  ===========  ============  ==========  =======  ===========

The Q8 serving tier (int8 weight-only matmuls) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

__all__ = ["Policy", "O0", "O1", "O2", "O3", "O4", "O5", "opt_levels",
           "get_policy"]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Immutable precision policy."""

    opt_level: str = "O5"
    # dtype model params are stored/computed in (None = leave fp32)
    cast_model_type: Optional[torch.dtype] = None
    # op-level autocasting (O1/O4)
    cast_ops: bool = False
    cast_ops_type: Optional[torch.dtype] = None
    keep_batchnorm_fp32: Optional[bool] = None
    # fp32 master copies of low-precision params
    master_weights: Optional[bool] = None
    # "dynamic", a float, or None (= 1.0)
    loss_scale: Union[str, float, None] = None
    cast_model_outputs: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.cast_ops and self.cast_model_type is not None:
            raise ValueError("cast_ops (O1/O4-style) and cast_model_type "
                             "(O2/O5-style) are mutually exclusive")
        if self.cast_ops and self.cast_ops_type is None:
            object.__setattr__(self, "cast_ops_type", torch.bfloat16)
        if self.master_weights and self.cast_model_type is None:
            raise ValueError("master_weights=True requires a "
                             "low-precision cast_model_type.")

    @property
    def param_dtype(self) -> torch.dtype:
        return self.cast_model_type or torch.float32

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


O0 = Policy(opt_level="O0", keep_batchnorm_fp32=None, master_weights=False,
            loss_scale=1.0)
O1 = Policy(opt_level="O1", cast_ops=True, cast_ops_type=torch.float16,
            keep_batchnorm_fp32=None, master_weights=False,
            loss_scale="dynamic")
O2 = Policy(opt_level="O2", cast_model_type=torch.float16,
            keep_batchnorm_fp32=True, master_weights=True,
            loss_scale="dynamic")
O3 = Policy(opt_level="O3", cast_model_type=torch.float16,
            keep_batchnorm_fp32=False, master_weights=False, loss_scale=1.0)
O4 = Policy(opt_level="O4", cast_ops=True, cast_ops_type=torch.bfloat16,
            keep_batchnorm_fp32=None, master_weights=False, loss_scale=1.0)
O5 = Policy(opt_level="O5", cast_model_type=torch.bfloat16,
            keep_batchnorm_fp32=True, master_weights=True, loss_scale=1.0)

opt_levels = {"O0": O0, "O1": O1, "O2": O2, "O3": O3, "O4": O4, "O5": O5}


def get_policy(opt_level: Union[str, Policy] = "O5", **overrides) -> Policy:
    """Look up a preset and apply overrides."""
    if isinstance(opt_level, Policy):
        policy = opt_level
    else:
        try:
            policy = opt_levels[opt_level]
        except KeyError:
            raise ValueError(f"Unexpected opt_level {opt_level!r}; "
                             f"expected one of {sorted(opt_levels)}"
                             ) from None
    if overrides:
        policy = policy.replace(**overrides)
    return policy
