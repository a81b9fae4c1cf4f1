"""ResNet v1.5 (the reference's canonical amp workload) in PyTorch.

Port of ``apex_tpu/models/resnet.py`` (``Bottleneck``, ``ResNet``,
``ResNet50/101/152``) and of the imagenet script's ``resnet_tiny``
(``examples/imagenet/main_amp.py:205-209``).  Submodules carry the flax
names (``conv1``, ``SyncBatchNorm_0``, ``stage1_block0``, ``fc``, ...),
so :func:`~apex_tpu_torch.amp.cast.default_bn_predicate` keeps the batch
norms fp32 under O5 as flax's ``SyncBatchNorm_k`` names do, and
:func:`resnet_state_from_numpy` carries a JAX ``params`` /
``batch_stats`` pair across by name.

What the port keeps of JAX's numbers:

* **Layout.**  :meth:`ResNet.forward` takes JAX's (N, H, W, C) images;
  the permute to (N, C, H, W) is a channels-last view (no copy), and
  every activation stays channels-last (``torch.channels_last``).  The
  convolutions are cuDNN's ``F.conv2d`` (JAX leaves them to XLA: no
  Pallas kernel); the weights keep PyTorch's (O, I, kH, kW) layout.
* **flax "SAME" padding**, which is asymmetric at stride 2: ``lo =
  total // 2``, ``hi = total - lo`` (``lax.padtype_to_pads``), so the
  7x7/2 stem at 224 pads (2, 3), a stage's first 3x3/2 conv (0, 1) and
  the 3x3/2 max pool (0, 1) with -inf.  PyTorch's symmetric ``padding=``
  would give the same output size over windows shifted by one, so an
  asymmetric pad is written out with ``F.pad``.
* **dtypes**: each convolution casts its input and weight to the
  model's compute dtype (flax's ``promote_dtype``); batch norm keeps
  fp32 parameters and returns the input's dtype; the residual is cast
  to the block output's dtype; the global mean pool sums in fp32 and
  rounds to the compute dtype (``jnp.mean`` of bf16); the classifier
  runs in fp32 on the fp32 value of its (under O5, bf16-rounded)
  weight.
* **train / eval**: ``forward(x, train=...)`` (default
  ``self.training``); ``train=False`` normalises with the running
  averages, as the graft entry calls it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["same_pads", "Conv", "Bottleneck", "ResNet", "ResNet50",
           "ResNet101", "ResNet152", "resnet_tiny", "ARCHS",
           "resnet_state_from_numpy"]


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial axis: ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0
              ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``x`` padded for a "SAME" window: symmetric pads are returned for
    the op's own ``padding=`` (no copy); asymmetric ones are applied with
    ``F.pad`` (kept channels-last) and ``(0, 0)`` is returned."""
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, use_bias=False)`` with
    "SAME" padding, computing in the dtype the caller passes."""

    def __init__(self, in_features: int, features: int, k: int,
                 stride: int = 1, device=None):
        super().__init__()
        self.k, self.stride = int(k), int(stride)
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k,
                                               device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x, pad = _pad_same(x.to(dtype), self.k, self.stride)
        return F.conv2d(x, self.weight.to(dtype), stride=self.stride,
                        padding=pad)

    def reset_parameters(self, g: torch.Generator) -> None:
        """flax's default kernel init, lecun normal (std 1/sqrt(fan_in)),
        untruncated."""
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)


def _default_norm(num_features: int, device=None, **kw) -> SyncBatchNorm:
    # local (non-synchronized) batch norm in fp32, as JAX's _default_norm
    kw.setdefault("axis_name", None)
    return SyncBatchNorm(num_features, device=device, **kw)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: the stride lives in the 3x3 conv."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False,
                 norm_factory: Callable = _default_norm, device=None):
        super().__init__()
        self.conv1 = Conv(in_features, features, 1, device=device)
        self.SyncBatchNorm_0 = norm_factory(features, device=device)
        self.conv2 = Conv(features, features, 3, stride, device=device)
        self.SyncBatchNorm_1 = norm_factory(features, device=device)
        self.conv3 = Conv(features, features * 4, 1, device=device)
        self.SyncBatchNorm_2 = norm_factory(features * 4, device=device)
        self.downsample = bool(downsample)
        if downsample:
            self.downsample_conv = Conv(in_features, features * 4, 1, stride,
                                        device=device)
            self.SyncBatchNorm_3 = norm_factory(features * 4, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        ura = not train
        y = F.relu(self.SyncBatchNorm_0(self.conv1(x, dtype), ura))
        y = F.relu(self.SyncBatchNorm_1(self.conv2(y, dtype), ura))
        y = self.SyncBatchNorm_2(self.conv3(y, dtype), ura)
        residual = x
        if self.downsample:
            residual = self.SyncBatchNorm_3(self.downsample_conv(x, dtype),
                                            ura)
        return F.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """flax ``ResNet(stage_sizes, num_classes, width, norm_factory,
    dtype)``; ``dtype`` is the compute dtype of the convolutions."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, norm_factory: Callable = _default_norm,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        self.dtype = dtype
        self.conv1 = Conv(3, width, 7, 2, device=device)
        self.SyncBatchNorm_0 = norm_factory(width, device=device)
        cin = width
        self.blocks = []
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = width * 2 ** stage
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, Bottleneck(
                    cin, features, stride, downsample=block == 0,
                    norm_factory=norm_factory, device=device))
                self.blocks.append(name)
                cin = features * 4
        self.fc = nn.Linear(cin, num_classes, device=device)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        """Logits (N, num_classes), fp32, of (N, H, W, 3) images."""
        if train is None:
            train = self.training
        dt = self.dtype
        y = x.permute(0, 3, 1, 2)             # NCHW view, channels-last
        y = F.relu(self.SyncBatchNorm_0(self.conv1(y, dt), not train))
        y, pad = _pad_same(y, 3, 2, value=-math.inf)
        y = F.max_pool2d(y, 3, 2, padding=pad)
        for name in self.blocks:
            y = getattr(self, name)(y, dt, train)
        y = y.float().mean((2, 3)).to(y.dtype)
        return F.linear(y.float(), self.fc.weight.float(),
                        self.fc.bias.float())

    def reset_parameters(self, g: torch.Generator) -> "ResNet":
        """Seeded weights in flax's default inits: lecun normal kernels
        (untruncated), zero Dense bias, unit and zero batch-norm affine;
        the running statistics at 0 and 1."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    m.reset_parameters(g)
                elif isinstance(m, SyncBatchNorm):
                    m.mean.zero_()
                    m.var.fill_(1.0)
                    if m.weight is not None:
                        m.weight.fill_(1.0)
                        m.bias.zero_()
            self.fc.weight.normal_(
                0.0, 1.0 / math.sqrt(self.fc.in_features), generator=g)
            self.fc.bias.zero_()
        return self


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kw)


def resnet_tiny(**kw) -> ResNet:
    """``main_amp``'s 2-stage narrow net (quick CPU runs)."""
    return ResNet(stage_sizes=(1, 1), width=16, **kw)


ARCHS = {"resnet50": ResNet50, "resnet101": ResNet101,
         "resnet152": ResNet152, "resnet_tiny": resnet_tiny}


def resnet_state_from_numpy(params: dict, batch_stats: Optional[dict] = None
                            ) -> dict:
    """A JAX ResNet's ``params`` (and ``batch_stats``), as nested dicts of
    numpy arrays, as a state dict of this module: conv kernels HWIO ->
    OIHW, the Dense kernel (in, out) -> (out, in), batch-norm weight,
    bias, mean and var as they are."""
    out = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, name + ".")
                continue
            a = np.asarray(val, np.float32)
            if key == "kernel" and a.ndim == 4:
                a, key = a.transpose(3, 2, 0, 1), "weight"
            elif key == "kernel":
                a, key = a.T, "weight"
            out[f"{prefix}{key}"] = torch.from_numpy(np.array(a, copy=True))

    walk(params, "")
    if batch_stats is not None:
        walk(batch_stats, "")
    return out
