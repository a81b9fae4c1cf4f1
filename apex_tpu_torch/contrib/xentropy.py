"""Softmax cross-entropy with label smoothing, under autograd.

Port of ``apex_tpu/contrib/xentropy/__init__.py:22-90`` with the same
forward and backward math.  Forward: the row max in the logits' own
dtype (exact), an fp32 log-sum-exp, and the label logit gathered from
the low-precision logits; only the per-row lse is kept.  Backward:
probabilities recomputed from the lse, ``(probs - target) * dloss``
written in the logits' dtype.  Plain PyTorch, as in the JAX package
(no Pallas kernel there); the backward works in place on its one fp32
(tokens, vocab) temporary.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["SoftmaxCrossEntropyFunction", "softmax_cross_entropy_loss"]


def _f32_copy(x: torch.Tensor) -> torch.Tensor:
    """An fp32 copy of x that in-place ops may overwrite (``x.float()``
    returns x itself when it is fp32 already)."""
    return x.to(torch.float32, copy=True)


class SoftmaxCrossEntropyFunction(torch.autograd.Function):
    """Per-row CE over (..., vocab) logits; see the module docstring."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing, half_to_float, padding_idx):
        m = logits.amax(dim=-1).float()
        lse = m + torch.log(_f32_copy(logits).sub_(m.unsqueeze(-1)).exp_()
                            .sum(dim=-1))
        x_label = logits.gather(-1, labels.unsqueeze(-1)).squeeze(-1)
        loss = lse - x_label.float()
        if smoothing > 0.0:
            smooth = lse - logits.float().mean(dim=-1)
            loss = (1.0 - smoothing) * loss + smoothing * smooth
        if padding_idx is not None:
            loss = loss.masked_fill(labels == padding_idx, 0.0)
        if not half_to_float:
            loss = loss.to(logits.dtype)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing, ctx.padding_idx = smoothing, padding_idx
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        smoothing = ctx.smoothing
        vocab = logits.shape[-1]
        dloss = dloss.float()
        if ctx.padding_idx is not None:
            dloss = dloss.masked_fill(labels == ctx.padding_idx, 0.0)
        # probs - target, target = smoothing/vocab off the label and
        # 1 - smoothing + smoothing/vocab on it
        dx = _f32_copy(logits).sub_(lse.unsqueeze(-1)).exp_()
        if smoothing > 0.0:
            dx.sub_(smoothing / vocab)
        dx.scatter_add_(-1, labels.unsqueeze(-1), torch.full(
            labels.unsqueeze(-1).shape, -(1.0 - smoothing),
            dtype=dx.dtype, device=dx.device))
        dx.mul_(dloss.unsqueeze(-1))
        return dx.to(logits.dtype), None, None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               half_to_float: bool = False,
                               padding_idx: Optional[int] = None
                               ) -> torch.Tensor:
    """Per-row CE loss; rows whose label is ``padding_idx`` give zero
    loss and zero gradient.  ``half_to_float`` returns the losses in
    fp32 whatever the logits' dtype."""
    return SoftmaxCrossEntropyFunction.apply(logits, labels, float(smoothing),
                                             bool(half_to_float), padding_idx)
