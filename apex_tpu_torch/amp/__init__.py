"""Mixed precision: the policy table, the casts, the loss scale and the
amp optimizer over its two routes, the staged per-leaf step and the
persistent fused pipeline."""
from . import cast, scaler
from .mixed_precision import (AmpOptimizer, StepInfo, initialize,
                              PIPELINE_PACK_MIN_BYTES, packed_nbytes)
from .policy import (O0, O1, O2, O3, O4, O5, Q8, Policy, get_policy,
                     opt_levels)

__all__ = ["Policy", "O0", "O1", "O2", "O3", "O4", "O5", "Q8", "opt_levels",
           "get_policy", "cast", "scaler", "AmpOptimizer", "StepInfo",
           "initialize", "packed_nbytes", "PIPELINE_PACK_MIN_BYTES"]
