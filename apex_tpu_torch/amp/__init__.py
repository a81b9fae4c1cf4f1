"""Mixed precision: the policy table, the casts, the loss scale, op-level
autocasting (O1/O4) and the amp optimizer over its three routes: the
staged per-leaf step with fp32 masters, the persistent fused pipeline,
and, for the policies without master weights (O0, O1, O3, O4), the
staged step on the parameters themselves."""
from . import cast, lists, scaler
from .autocast import (autocast, bfloat16_function, float_function,
                       half_function, promote_function)
from .cast import (cast_inputs, cast_outputs, cast_params, convert_network,
                   master_copy, restore_dtypes, tree_cast)
from .mixed_precision import (AmpOptimizer, StepInfo, initialize,
                              PIPELINE_PACK_MIN_BYTES, packed_nbytes)
from .policy import (O0, O1, O2, O3, O4, O5, Q8, Policy, get_policy,
                     opt_levels)

__all__ = ["Policy", "O0", "O1", "O2", "O3", "O4", "O5", "Q8", "opt_levels",
           "get_policy", "cast", "lists", "scaler", "autocast",
           "half_function", "bfloat16_function",
           "float_function", "promote_function", "cast_params",
           "cast_inputs", "cast_outputs", "convert_network", "master_copy",
           "restore_dtypes", "tree_cast", "AmpOptimizer", "StepInfo",
           "initialize", "packed_nbytes", "PIPELINE_PACK_MIN_BYTES"]
