"""Megatron-style global singletons for the port's test stack.

Port of ``apex_tpu/testing/global_vars.py`` (the surface of
``apex/transformer/testing/global_vars.py:26-190``):
:func:`set_global_variables` parses the arguments
(:func:`~apex_tpu_torch.testing.arguments.parse_args`) and builds the
microbatch calculator from them; :func:`get_args`,
:func:`get_num_microbatches`, :func:`get_current_global_batch_size` and
:func:`update_num_microbatches` read and advance them;
:func:`destroy_global_vars` resets both (tests share a process).
"""
from __future__ import annotations

from ..transformer.microbatches import (NumMicroBatchesCalculator,
                                        build_num_microbatches_calculator)
from .arguments import parse_args as _parse_args

__all__ = ["set_global_variables", "get_args", "get_num_microbatches",
           "get_current_global_batch_size", "update_num_microbatches",
           "destroy_global_vars"]

_GLOBAL_ARGS = None
_GLOBAL_NUM_MICROBATCHES_CALCULATOR: NumMicroBatchesCalculator = None


def _ensure_initialized(var, name):
    if var is None:
        raise RuntimeError(f"{name} is not initialized")


def get_args():
    """The parsed arguments (ref: ``global_vars.py:34-37``)."""
    _ensure_initialized(_GLOBAL_ARGS, "args")
    return _GLOBAL_ARGS


def get_num_microbatches() -> int:
    _ensure_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                        "num microbatches calculator")
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> int:
    _ensure_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                        "num microbatches calculator")
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int, *,
                            consistency_check: bool = True) -> None:
    _ensure_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                        "num microbatches calculator")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def set_global_variables(extra_args_provider=None, args_defaults=None,
                         ignore_unknown_args=False, args=None):
    """Parse the arguments and build the microbatch calculator (ref:
    ``global_vars.py:87-99``); raises if they are set already.  Returns
    the arguments."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_ARGS is not None:
        raise RuntimeError("args is already initialized")
    parsed = _parse_args(extra_args_provider=extra_args_provider,
                         defaults=args_defaults or {},
                         ignore_unknown_args=ignore_unknown_args, args=args)
    if parsed.global_batch_size is not None \
            and parsed.micro_batch_size is not None:
        _GLOBAL_NUM_MICROBATCHES_CALCULATOR = \
            build_num_microbatches_calculator(
                0, parsed.rampup_batch_size, parsed.global_batch_size,
                parsed.micro_batch_size, parsed.data_parallel_size)
    _GLOBAL_ARGS = parsed
    return parsed


def destroy_global_vars() -> None:
    """Reset the arguments and the calculator."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_ARGS = None
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
