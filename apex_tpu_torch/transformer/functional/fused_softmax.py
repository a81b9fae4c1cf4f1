"""``FusedScaleMaskSoftmax``: scale, mask and softmax, fused where the
kernels are eligible.

Port of ``apex_tpu/transformer/functional/fused_softmax.py:24-127`` with
the same eligibility rule: the fused path needs fusion enabled, a
low-precision model (``input_in_fp16`` or ``input_in_bf16``) and sk > 1;
anything else takes the plain :meth:`forward_torch_softmax` (the JAX
``forward_jax_softmax``: a -10000 fill for the causal triangle or the
padding mask, then a max-subtracted softmax).  The probabilities leave
in the model dtype given by the constructor flags, not the input's
dtype, so fp32 scores straight off the matmul go in and fp16 or bf16
probabilities come out.

The causal fused path runs the scaled-softmax kernels
(:func:`~apex_tpu_torch.ops.scaled_upper_triang_masked_softmax`, rows 3
and 4 of the kernel table), or their plain versions with ``kernels``
False (the oracle configuration).  The fused padding path needs
``_masked_fwd`` (row 5), which is not ported yet, and raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ...ops.scaled_softmax import scaled_upper_triang_masked_softmax
from ..enums import AttnMaskType

__all__ = ["FusedScaleMaskSoftmax"]


class FusedScaleMaskSoftmax:
    """Fused scale + mask + softmax (ref:
    ``apex_tpu/transformer/functional/fused_softmax.py:24``); the
    arguments are the reference's."""

    def __init__(self, input_in_fp16: bool, input_in_bf16: bool,
                 attn_mask_type: AttnMaskType,
                 scaled_masked_softmax_fusion: bool,
                 mask_func: Optional[Callable], softmax_in_fp32: bool,
                 scale: Optional[float], *, kernels: bool = True):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags cannot be active "
                               "at the same time")
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")
        self.input_in_fp16 = input_in_fp16
        self.input_in_bf16 = input_in_bf16
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.scaled_masked_softmax_fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        self.kernels = kernels

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """Fused-path eligibility: fusion on, a low-precision model and
        sk > 1 (the kernels take any shape)."""
        return bool(self.scaled_masked_softmax_fusion
                    and self.input_in_float16 and sk > 1)

    def _model_dtype(self) -> Optional[torch.dtype]:
        if self.input_in_fp16:
            return torch.float16
        if self.input_in_bf16:
            return torch.bfloat16
        return None

    def _exit_cast(self, probs: torch.Tensor) -> torch.Tensor:
        dtype = self._model_dtype()
        return probs.to(dtype) if dtype is not None else probs

    def __call__(self, inputs: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, np_, sq, sk = inputs.shape
        if self.is_kernel_available(mask, b, np_, sq, sk):
            return self.forward_fused_softmax(inputs, mask)
        return self.forward_torch_softmax(inputs, mask)

    def forward_fused_softmax(self, inputs: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
        scale = self.scale if self.scale is not None else 1.0
        if self.attn_mask_type != AttnMaskType.causal:
            raise NotImplementedError(
                "the fused padding-mask softmax needs `_masked_fwd` (row 5 "
                "of the kernel table), which is not ported yet")
        b, np_, sq, sk = inputs.shape
        if sq != sk:
            raise ValueError("causal mask is only for self attention")
        probs = scaled_upper_triang_masked_softmax(
            inputs.reshape(-1, sq, sk), scale, kernels=self.kernels)
        return self._exit_cast(probs.reshape(b, np_, sq, sk))

    def forward_torch_softmax(self, inputs: torch.Tensor,
                              mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The unfused path (ref: ``forward_jax_softmax``,
        ``fused_softmax.py:103-127``)."""
        if self.input_in_float16 and self.softmax_in_fp32:
            inputs = inputs.float()
        if self.scale is not None:
            inputs = inputs * self.scale
        if self.attn_mask_type == AttnMaskType.causal:
            sq, sk = inputs.shape[-2:]
            keep = torch.ones(sq, sk, dtype=torch.bool,
                              device=inputs.device).tril()
            inputs = inputs.masked_fill(~keep, -10000.0)
        elif mask is not None:
            if self.mask_func is not None:
                inputs = self.mask_func(inputs, mask)
            else:
                # the default mask function: fill the masked (True)
                # positions, never drop the mask
                inputs = inputs.masked_fill(mask.bool(), -10000.0)
        probs = torch.exp(inputs - inputs.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        if self.softmax_in_fp32:
            probs = self._exit_cast(probs)
        return probs
