"""apex_tpu_torch: the PyTorch / NVIDIA Hopper port of ``apex_tpu``.

The package mirrors ``apex_tpu``'s module names (``ops/``, ``serving/``,
``testing/``, ``amp/``, ``normalization/``, ``transformer/``,
``contrib/``, ``optimizers/``) so each port module sits where its JAX
counterpart does.  Plain tensor code is PyTorch; every kernel that the
JAX package wrote in Pallas is a CUDA C++ kernel under ``csrc/``, built
for ``sm_90a`` with ``nvcc`` at first use and bound through ``ctypes``
(:mod:`apex_tpu_torch._build`).

The package never imports ``jax`` or ``apex_tpu``; it keeps its own
copies of what it needs.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, and raise when no GPU is present and
the CPU was not asked for (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the
    CPU only when asked for by name.  Raises when a CUDA device is
    wanted and none is present — the port never carries on quietly on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev
