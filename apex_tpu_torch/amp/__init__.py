"""Mixed precision: the policy table, the casts, the loss scale and the
amp optimizer over the persistent fused pipeline."""
from . import cast, scaler
from .mixed_precision import AmpOptimizer, StepInfo, initialize
from .policy import (O0, O1, O2, O3, O4, O5, Q8, Policy, get_policy,
                     opt_levels)

__all__ = ["Policy", "O0", "O1", "O2", "O3", "O4", "O5", "Q8", "opt_levels",
           "get_policy", "cast", "scaler", "AmpOptimizer", "StepInfo",
           "initialize"]
