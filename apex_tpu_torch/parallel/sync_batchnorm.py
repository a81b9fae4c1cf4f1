"""SyncBatchNorm on one rank: batch norm in JAX's formula.

Port of ``apex_tpu/parallel/sync_batchnorm.py`` (``SyncBatchNorm``,
``convert_syncbn_model``) with ``axis_name=None``, the local batch norm
the JAX module degrades to outside a mesh.  The statistics are JAX's,
not ``F.batch_norm``'s (whose Welford sums round otherwise): fp32 sums
``s1`` and ``s2`` over every axis but the channel's, ``mean = s1 / n``,
the biased ``var = s2 / n - mean**2`` for the normalisation, and the
unbiased ``var * n / max(n - 1, 1)`` for the running estimate at
``momentum`` 0.1; the output is cast back to the input's dtype.  The
running buffers, named ``mean`` and ``var`` as JAX's ``batch_stats``,
start at 0 and 1 and move only in a training forward (JAX makes no
update while it initialises).

The layout is PyTorch's, the channel on axis 1 ((N, C, ...), of any
memory format; JAX's module takes it last).  The training forward is a
``torch.autograd.Function`` that saves only the input, the mean and
``rstd`` (two fp32 vectors): no fp32 copy of an activation outlives the
forward, where autograd through the plain expression would keep several.
Its backward is the same formula differentiated (JAX leaves it to
autodiff): with ``xhat = (x - mean) * rstd``,
``dbias = sum(dy)``, ``dweight = sum(dy * xhat)`` and
``dx = rstd * weight * (dy - dbias / n - xhat * dweight / n)``, in fp32,
cast to the input's dtype.  Any ``axis_name`` but None raises: the
cross-rank reduction is ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]


def _refuse_axis(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"SyncBatchNorm over axis {axis_name!r}: the cross-rank "
            f"statistics are not ported (ROADMAP Queue 1 item 8); pass "
            f"axis_name=None for the local batch norm")


class _BatchNormTrain(torch.autograd.Function):
    """The training forward and its backward; returns ``(y, mean,
    var)``, the statistics not differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        x32 = x.float()
        mean = x32.sum(dims) / n
        var = (x32 * x32).sum(dims) / n - mean * mean
        rstd = torch.rsqrt(var + eps)
        y = (x32 - mean.view(shape)) * rstd.view(shape)
        del x32
        if weight is not None:
            y = y * weight.float().view(shape) + bias.float().view(shape)
        ctx.save_for_backward(x, mean, rstd, weight)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, weight = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        dy32 = dy.float()
        xhat = (x.float() - mean.view(shape)) * rstd.view(shape)
        dbias = dy32.sum(dims)
        dweight = (dy32 * xhat).sum(dims)
        scale = rstd if weight is None else rstd * weight.float()
        dx = (dy32 - (dbias / n).view(shape)
              - xhat * (dweight / n).view(shape)) * scale.view(shape)
        if weight is None:
            return dx.to(x.dtype), None, None, None
        return dx.to(x.dtype), dweight, dbias, None


class SyncBatchNorm(nn.Module):
    """``apex.parallel.SyncBatchNorm(num_features, eps, momentum, affine,
    track_running_stats, axis_name, fuse_relu)`` over (N, C, ...)
    inputs, one rank (``axis_name=None``)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None, fuse_relu: bool = False,
                 device=None):
        super().__init__()
        _refuse_axis(axis_name)
        self.num_features = int(num_features)
        self.eps, self.momentum = float(eps), float(momentum)
        self.track_running_stats = bool(track_running_stats)
        self.fuse_relu = bool(fuse_relu)
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("mean", torch.zeros(self.num_features, **f32))
        self.register_buffer("var", torch.ones(self.num_features, **f32))
        if affine:
            self.weight = nn.Parameter(torch.ones(self.num_features, **f32))
            self.bias = nn.Parameter(torch.zeros(self.num_features, **f32))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        """Batch statistics (and a running update) unless
        ``use_running_average`` (default: ``not self.training``)."""
        if x.dim() < 2 or x.shape[1] != self.num_features:
            raise ValueError(f"expected channel dim {self.num_features} on "
                             f"axis 1, got {tuple(x.shape)}")
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            shape = [1, self.num_features] + [1] * (x.dim() - 2)
            y = (x.float() - self.mean.view(shape)) * torch.rsqrt(
                self.var + self.eps).view(shape)
            if self.weight is not None:
                y = y * self.weight.float().view(shape) + \
                    self.bias.float().view(shape)
            y = y.to(x.dtype)
        else:
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                                 self.eps)
            if self.track_running_stats:
                n = x.numel() // x.shape[1]
                m = self.momentum
                with torch.no_grad():
                    unbiased = var * float(n) / float(max(n - 1, 1))
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
        return torch.relu(y) if self.fuse_relu else y


def convert_syncbn_model(norm_factory=None, axis_name: Optional[str] = None):
    """A norm-layer factory making :class:`SyncBatchNorm` (the JAX
    package's form: its models take a ``norm_factory`` at construction
    instead of converting a module tree).  ``axis_name`` other than None
    raises (ROADMAP Queue 1 item 8)."""
    del norm_factory
    _refuse_axis(axis_name)

    def factory(num_features, **kw):
        kw.setdefault("axis_name", axis_name)
        return SyncBatchNorm(num_features, **kw)

    return factory
