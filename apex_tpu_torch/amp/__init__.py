"""Mixed precision (the policy table; the training machinery comes with
the train-step slice)."""
from .policy import (O0, O1, O2, O3, O4, O5, Policy, get_policy,
                     opt_levels)

__all__ = ["Policy", "O0", "O1", "O2", "O3", "O4", "O5", "opt_levels",
           "get_policy"]
