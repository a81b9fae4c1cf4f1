"""ImageNet ResNet training script of the port, on synthetic data.

Port of ``examples/imagenet/main_amp.py``'s synthetic mode (``:116-148``
``synthetic_batch`` / ``build_train_step``, ``:200-230`` the archs, the
optimizer and ``amp.initialize``): a ResNet from seeded weights, amp at
an opt level (O5 by default: bf16 convolutions, fp32 batch norm, fp32
masters), ``fused_sgd(lr, momentum, weight_decay)`` or
``fused_adam(lr, weight_decay=...)``, and the loss
``mean(softmax_cross_entropy_loss(logits, labels, half_to_float=True))``.
amp routes the step as JAX does (``pipeline=None``): ResNet-50's cast
model is 51 MB, under the 128 MiB cutoff, so it takes the staged
route: one ``sgd_step_leaves`` (or ``adam_step_leaves``) call a step, a
kernel launch a dtype pair and table of parameters
(``make_train_setup(pipeline=True)`` takes the persistent pipeline).
Runs on the card unless ``--device cpu``::

    python -m apex_tpu_torch.examples.imagenet.main_amp --synthetic \\
        --arch resnet50 -b 256 --iters 8
    python -m apex_tpu_torch.examples.imagenet.main_amp --synthetic \\
        --arch resnet_tiny -b 4 --image-size 32 --iters 4 --device cpu

Each iteration draws a new batch from the seeded generator, as the JAX
script splits its key.  Left out (ROADMAP Queue 1 items 8-9): ``--data``
and its DataLoader, checkpoint save and resume, and the device mesh
(one card, so batch norm is the local one).  :func:`train_smoke` is the
one-batch form ``chip_smoke.py`` drives.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import amp, resolve_device
from ...contrib.xentropy import softmax_cross_entropy_loss
from ...models.resnet import ARCHS
from ...optimizers import fused_adam, fused_sgd

__all__ = ["RN50_TRAIN_FLOPS_PER_IMG", "TrainSetup", "TrainResult",
           "make_policy", "make_train_setup", "synthetic_batch",
           "train_step", "run_steps", "train_smoke", "main"]

# bench.py:92: ResNet-50's forward is ~4.1 GFLOP a 224x224 image, a train
# step ~3x the forward
RN50_TRAIN_FLOPS_PER_IMG = 3 * 4.1e9


def make_policy(opt_level: str = "O5", loss_scale=None) -> amp.Policy:
    """The opt level's policy with ``--loss-scale`` ("dynamic" or a
    number) applied."""
    if loss_scale is None:
        return amp.get_policy(opt_level)
    return amp.get_policy(opt_level, loss_scale="dynamic"
                          if loss_scale == "dynamic" else float(loss_scale))


def synthetic_batch(g: torch.Generator, batch: int, size: int,
                    num_classes: int, dtype: torch.dtype, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal (batch, size, size, 3) images in ``dtype`` and
    uniform labels, from ``g``."""
    images = torch.randn(batch, size, size, 3, generator=g,
                         device=device).to(dtype)
    labels = torch.randint(0, num_classes, (batch,), generator=g,
                           device=device)
    return images, labels


@dataclasses.dataclass
class TrainSetup:
    """The cast model, its amp optimizer, the seeded generator and one
    batch, and the model FLOPs of a step (None but for ResNet-50)."""

    model: torch.nn.Module
    amp_opt: amp.AmpOptimizer
    generator: torch.Generator
    images: torch.Tensor
    labels: torch.Tensor
    n_params: int
    flops_per_step: Optional[float]

    @property
    def batch(self) -> int:
        return self.images.shape[0]


def make_train_setup(arch: str = "resnet50", *, batch: int = 256,
                     image_size: int = 224, num_classes: int = 1000,
                     opt_level: str = "O5", loss_scale=None,
                     optimizer: str = "sgd", lr: float = 0.1,
                     momentum: float = 0.9, weight_decay: float = 1e-4,
                     seed: int = 0, kernels: bool = True,
                     pipeline: Optional[bool] = None,
                     device=None) -> TrainSetup:
    """Build ``arch`` from seeded weights on ``device`` (cuda unless the
    CPU is asked for), ``amp.initialize`` it with this script's optimizer
    at ``opt_level`` (``pipeline`` None: JAX's routing), and draw one
    batch from the same seed.  ``kernels=False`` runs the optimizer's
    plain versions (the oracle configuration; the model has no kernel
    of the port: cuDNN convolutions, plain batch norm)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r} (choices: {sorted(ARCHS)})")
    if optimizer not in ("sgd", "adam"):
        raise ValueError(f"optimizer {optimizer!r} is not sgd or adam")
    dev = resolve_device(device)
    policy = make_policy(opt_level, loss_scale)
    dtype = policy.cast_model_type or torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    model = ARCHS[arch](num_classes=num_classes, dtype=dtype,
                        device=dev).reset_parameters(g)
    n_params = sum(p.numel() for p in model.parameters())
    if optimizer == "sgd":
        tx = fused_sgd(lr, momentum=momentum, weight_decay=weight_decay,
                       kernels=kernels)
    else:
        tx = fused_adam(lr, weight_decay=weight_decay, kernels=kernels)
    model, amp_opt = amp.initialize(model, tx, opt_level=policy,
                                    pipeline=pipeline)
    images, labels = synthetic_batch(g, batch, image_size, num_classes,
                                     dtype, dev)
    flops = RN50_TRAIN_FLOPS_PER_IMG * batch * (image_size / 224) ** 2 \
        if arch == "resnet50" else None
    return TrainSetup(model, amp_opt, g, images, labels, n_params, flops)


def train_step(setup: TrainSetup, images: Optional[torch.Tensor] = None,
               labels: Optional[torch.Tensor] = None):
    """One step on ``images``/``labels`` (default: the setup's batch):
    zero the grads, forward in train mode, the scaled loss's backward,
    and amp's optimizer step.  Returns the (unscaled) loss, still on the
    device, the step's ``StepInfo``, and the host ms the optimizer step
    took to issue."""
    images = setup.images if images is None else images
    labels = setup.labels if labels is None else labels
    setup.amp_opt.zero_grad()
    logits = setup.model(images, train=True)
    loss = softmax_cross_entropy_loss(logits, labels,
                                      half_to_float=True).mean()
    setup.amp_opt.scale_loss(loss).backward()
    t0 = time.perf_counter()
    info = setup.amp_opt.apply_gradients()
    return loss.detach(), info, (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass
class TrainResult:
    """What :func:`train_smoke` ran and measured.  ``step_ms``: the host
    wall of each step through the read of its loss; ``opt_ms``: the host
    time of each step's ``apply_gradients`` call (its launches; under a
    dynamic scale also the one host read); ``median_ms`` the median of
    steps 3 on.  ``steps`` holds each step's ``(grads_finite,
    loss_scale, steps_skipped)``."""

    setup: TrainSetup
    losses: List[float]
    step_ms: List[float]
    opt_ms: List[float]
    steps: List[Tuple[bool, float, int]]

    @staticmethod
    def _median(xs) -> float:
        return float(np.median(xs[2:] if len(xs) > 2 else xs))

    @property
    def median_ms(self) -> float:
        return self._median(self.step_ms)

    @property
    def opt_median_ms(self) -> float:
        return self._median(self.opt_ms)

    @property
    def images_per_sec(self) -> float:
        return self.setup.batch / (self.median_ms / 1e3)

    @property
    def tflops_per_sec(self) -> Optional[float]:
        if self.setup.flops_per_step is None:
            return None
        return self.setup.flops_per_step / (self.median_ms / 1e3) / 1e12


def run_steps(setup: TrainSetup, steps: int, new_batches: bool = False
              ) -> TrainResult:
    """``steps`` :func:`train_step` s, each timed through the read of its
    loss: on the setup's batch, or (``new_batches``) on a new batch a
    step from the setup's generator, as the JAX script draws them."""
    losses, step_ms, opt_ms, infos = [], [], [], []
    for _ in range(steps):
        batch = (None, None)
        if new_batches:
            batch = synthetic_batch(
                setup.generator, setup.batch, setup.images.shape[1],
                setup.model.fc.out_features, setup.images.dtype,
                setup.images.device)
        t0 = time.perf_counter()
        loss, info, o_ms = train_step(setup, *batch)
        losses.append(float(loss))                # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        opt_ms.append(o_ms)
        infos.append((info.grads_finite, info.loss_scale,
                      info.steps_skipped))
    return TrainResult(setup, losses, step_ms, opt_ms, infos)


def train_smoke(steps: int = 8, **setup_kw) -> TrainResult:
    """:func:`make_train_setup` (``setup_kw``), then ``steps`` steps on
    its one batch, as bench.py's ``bench_resnet50`` trains."""
    return run_steps(make_train_setup(**setup_kw), steps)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.examples.imagenet.main_amp",
        description="ResNet training with apex_tpu_torch.amp on synthetic "
                    "data (ref: examples/imagenet/main_amp.py)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic random data (the only mode "
                        "ported)")
    p.add_argument("--arch", default="resnet50", choices=sorted(ARCHS))
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--print-freq", type=int, default=10)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--opt-level", default="O5",
                   help="O5 (bf16) or O2 (fp16, dynamic loss scale)")
    p.add_argument("--loss-scale", default=None,
                   help='None, "dynamic", or a number')
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--loss-log", default=None,
                   help="file to append per-iteration losses to")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)
    setup = make_train_setup(
        args.arch, batch=args.batch_size, image_size=args.image_size,
        num_classes=args.num_classes, opt_level=args.opt_level,
        loss_scale=args.loss_scale, optimizer=args.optimizer, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        seed=args.seed, device=args.device)
    route = "pipeline" if setup.amp_opt.use_pipeline else "staged"
    r = run_steps(setup, args.iters, new_batches=True)
    for it, (loss, (_, scale, _)) in enumerate(zip(r.losses, r.steps)):
        if it % args.print_freq == 0:
            print(f"it {it} step {it + 1} loss {loss:.4f} loss_scale "
                  f"{scale:.1f} step_ms {r.step_ms[it]:.3f}", flush=True)
    if args.loss_log:
        with open(args.loss_log, "a") as f:
            for it, loss in enumerate(r.losses):
                f.write(f"{it + 1} {loss:.6f}\n")
    _, scale, skipped = r.steps[-1]
    print(f"TRAIN_DONE arch={args.arch} opt_level={args.opt_level} "
          f"optimizer={args.optimizer} route={route} steps={len(r.losses)} "
          f"loss_first={r.losses[0]:.6f} loss_last={r.losses[-1]:.6f} "
          f"skipped={skipped} scale={scale:g} "
          f"step_ms_p50={r.median_ms:.3f} "
          f"images_s={r.images_per_sec:.1f} params={setup.n_params} "
          f"device={setup.images.device}", flush=True)
    return r.losses[-1]


if __name__ == "__main__":
    main()
