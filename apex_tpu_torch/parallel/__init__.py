"""Parallel training on one rank: synchronized batch norm.

Port of ``apex_tpu/parallel`` as far as one device goes: the batch norm
whose statistics span the data axis, with only the local statistics.
The data-parallel wrapper, LARC and the cross-rank reductions are ROADMAP
Queue 1 item 8.
"""
from .sync_batchnorm import SyncBatchNorm, convert_syncbn_model

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]
