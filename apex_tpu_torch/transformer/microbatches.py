"""Microbatch calculators: constant and ramped global batch sizes.

Port of ``apex_tpu/transformer/microbatches.py`` (itself
``apex/transformer/microbatches.py:21-172``): the calculator owns the
(global_batch_size, micro_batch_size, data_parallel_size) arithmetic
and, for the ramp-up variant, the piecewise-linear growth of the global
batch as samples are consumed.  Host-side Python.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Sequence


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[Sequence[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    """ref: microbatches.py:21-65 — selects constant vs ramp-up."""
    if rampup_batch_size is None:
        calculator = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
        if rank == 0:
            print(f"setting number of micro-batches to constant "
                  f"{calculator.get()}", flush=True)
        return calculator
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "expected the following format: --rampup-batch-size "
            "<start batch size> <batch size increment> "
            "<ramp-up samples>")
    start, increment, samples = map(int, rampup_batch_size)
    if rank == 0:
        print(f"will use batch size rampup starting from global batch "
              f"size {start} to global batch size {global_batch_size} "
              f"with batch size increments {increment} over {samples} "
              f"samples.", flush=True)
    return RampupBatchsizeNumMicroBatches(
        start, increment, samples, global_batch_size, micro_batch_size,
        data_parallel_size)


class NumMicroBatchesCalculator(ABC):
    """ref: microbatches.py:68-82."""

    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    @abstractmethod
    def update(self, consumed_samples, consistency_check):
        ...


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    """ref: microbatches.py:84-99."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible "
                f"by micro batch size ({micro_batch_size}) times data "
                f"parallel size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("number of microbatches must be at least 1")
        self.current_global_batch_size = global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Piecewise-linear global-batch ramp (ref: microbatches.py:101-172)."""

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        if self.micro_batch_times_data_parallel_size <= 0:
            raise ValueError("micro batch size * dp size must be positive")
        if start_batch_size <= 0:
            raise ValueError("start batch size must be positive")
        self.start_batch_size = start_batch_size
        if global_batch_size <= 0:
            raise ValueError("global batch size must be positive")
        self.global_batch_size = global_batch_size
        diff_batch_size = self.global_batch_size - self.start_batch_size
        if diff_batch_size < 0:
            raise ValueError(
                "expected global batch size to be greater than or equal to "
                "start batch size")
        if batch_size_increment <= 0:
            raise ValueError("batch size increment must be positive")
        self.batch_size_increment = batch_size_increment
        if diff_batch_size % batch_size_increment != 0:
            raise ValueError(
                f"expected global batch size interval ({diff_batch_size}) "
                f"to be divisible by global batch size increment "
                f"({batch_size_increment})")
        num_increments = diff_batch_size // self.batch_size_increment
        self.ramup_samples = ramup_samples
        if self.ramup_samples < 0:
            raise ValueError("ramp-up samples must be non-negative")
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments if num_increments > 0
            else 0)
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool):
        """ref: microbatches.py:155-172."""
        if consumed_samples > self.ramup_samples or \
                self.rampup_samples_per_increment == 0:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples /
                        self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment)
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size)
        if consistency_check and (
                self.current_global_batch_size %
                self.micro_batch_times_data_parallel_size != 0):
            raise ValueError(
                f"current global batch size "
                f"({self.current_global_batch_size}) is not divisible by "
                f"micro-batch-size ({self.micro_batch_size}) times data "
                f"parallel size ({self.data_parallel_size})")
        self.num_micro_batches = (
            self.current_global_batch_size //
            self.micro_batch_times_data_parallel_size)
