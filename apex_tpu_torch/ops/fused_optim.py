"""The per-leaf optimizer steps, LAMB phase 1 and the optax-style update
bodies: CUDA kernels and their plain versions.

Port of seven bodies of ``apex_tpu/ops/fused_optim.py`` (row 19 of the
kernel table), each run there by ``_elementwise_call``: the four update
bodies (``adam_update``, ``adagrad_update``, ``novograd_update``,
``sgd_update``; see the section below) and

* ``sgd_step`` (:393, body ``_sgd_step_kernel`` :368) and ``adam_step``
  (:220, body ``_adam_step_kernel`` :196): the single-pass steps of the
  staged amp route — over the gradient ``g`` (bf16, fp16 or fp32), the
  fp32 master ``p`` and the optimizer's fp32 state, the update in fp32,
  the new ``p`` and state written in place and, when the model keeps a
  low-precision copy, ``lowp`` cast from the new ``p`` in the same pass
  (the amp O2/O5 writeback).  JAX runs them leaf by leaf inside one
  jitted program; the port's :func:`sgd_step_leaves` and
  :func:`adam_step_leaves` take every leaf at once and launch one kernel
  a (g, lowp) dtype pair and table of leaves (``sgd_step`` and
  ``adam_step`` are their one-leaf calls).  The Adam step also takes a
  bf16 or fp16 ``p`` with no copy (amp's policies without master
  weights: O3 steps its fp16 parameters themselves): read into fp32,
  stepped by the same fp32 body, rounded back once, as JAX's kernel
  writes ``p_new.astype(p.dtype)``; a launch a (g, p) dtype pair and
  table.  JAX's ``flatten_for_kernel`` LANE padding has no counterpart:
  the kernels take any length;
* ``lamb_phase1`` (:262-305, body ``_lamb_phase1_kernel``): over one flat
  group —
  gradient ``g`` in the model's dtype, fp32 master ``p`` and moments
  ``m``, ``v`` — in fp32::

    g = g * grad_scale                 (+ weight_decay * p in L2 mode)
    m = beta1 * m + beta3 * g
    v = beta2 * v + (1 - beta2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps)   (+ weight_decay * p, AdamW)

  ``grad_scale`` is amp's inverse loss scale times the global-norm clip
  factor, folded into one multiplier as the JAX kernel takes it.  The
  port updates ``m`` and ``v`` in place (the JAX kernel returns new
  arrays) and writes ``u`` into a new fp32 buffer; ``p`` is only read.
  The per-tensor trust ratio (phase 2) is
  :mod:`apex_tpu_torch.optimizers.fused_lamb`'s, in plain torch.

On CUDA tensors the SGD steps launch ``csrc/fused_sgd.cu``'s table
kernel, the Adam steps ``csrc/fused_adam.cu``'s and
:func:`lamb_phase1` ``csrc/fused_lamb.cu``, or they raise; on CPU
tensors they run their plain versions.  The step kernels round every
operation in the plain versions' order (no FMA), so on the card the two
agree bit for bit;
their hyperparameters are rounded to fp32 once, on the host, as the JAX
kernels' fp32 hyperparameter vector holds them (``1 - dampening``,
``1 - beta`` included).  ``grad_scale`` may be a Python number or a 0-d
fp32 tensor on the buffers' device: the LAMB kernel reads it from device
memory, so a scale computed on the device (the clip factor under a
static loss scale) never makes the host wait.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _build
from ._counts import bump

__all__ = ["lamb_phase1", "lamb_phase1_reference", "sgd_step",
           "sgd_step_reference", "adam_step", "adam_step_reference",
           "sgd_step_leaves", "sgd_step_leaves_reference",
           "adam_step_leaves", "adam_step_leaves_reference",
           "step_capacity",
           "check_update_buffers", "adam_update", "adam_update_reference",
           "adagrad_update", "adagrad_update_reference", "novograd_update",
           "novograd_update_reference", "sgd_update",
           "sgd_update_reference"]

_G_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_LOWP_TAKES = (torch.bfloat16, torch.float16)

Scalar = Union[float, torch.Tensor]


def _scalar(x: Scalar, device) -> torch.Tensor:
    """An fp32 0-d tensor on ``device``: a Python number (or bool) is
    filled there (no host copy); a tensor is converted only if it must
    be."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), x, dtype=torch.float32, device=device)


def lamb_phase1_reference(g, p, m, v, *, grad_scale: Scalar, beta1, beta2,
                          beta3, eps, weight_decay, bias_correction1,
                          bias_correction2, adam_w_mode: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version of the kernel (the ``_lamb_phase1_kernel`` math):
    returns ``(u, m, v)``, ``m`` and ``v`` updated in place.  Scalars are
    fp32, as the JAX kernel's hyperparameter vector."""
    def c(x):
        return _scalar(x, p.device)

    b1, b2, b3, eps_, wd = c(beta1), c(beta2), c(beta3), c(eps), \
        c(weight_decay)
    bc1, bc2, gs = c(bias_correction1), c(bias_correction2), c(grad_scale)
    gf = g.float() * gs
    if not adam_w_mode:
        gf = gf + wd * p
    m.copy_(b1 * m + b3 * gf)
    v.copy_(b2 * v + (1.0 - b2) * gf * gf)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps_)
    if adam_w_mode:
        u = u + wd * p
    return u, m, v


def _launch(g, p, m, v, gscale, hyp, adam_w_mode):
    check_buffers("lamb_phase1", g, (p, m, v))
    n = p.numel()
    u = torch.empty_like(p)
    lib = _build.library("fused_lamb")
    with torch.cuda.device(p.device):
        rc = lib.apex_lamb_phase1(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            u.data_ptr(), gscale.data_ptr(), n, *(float(x) for x in hyp),
            int(bool(adam_w_mode)), _build.dtype_code(g.dtype),
            _build.stream_ptr(p.device))
    _build.check("fused_lamb", rc, "lamb_phase1 kernel")
    bump("lamb_phase1")
    return u


def lamb_phase1(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, grad_scale: Scalar, beta1: float,
                beta2: float, beta3: float, eps: float, weight_decay: float,
                bias_correction1: float, bias_correction2: float,
                adam_w_mode: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LAMB stage 1 over one flat group -> ``(u, m, v)``: ``u`` a new
    fp32 buffer, ``m`` and ``v`` updated in place, ``p`` read only."""
    if p.device.type == "cpu":
        return lamb_phase1_reference(
            g, p, m, v, grad_scale=grad_scale, beta1=beta1, beta2=beta2,
            beta3=beta3, eps=eps, weight_decay=weight_decay,
            bias_correction1=bias_correction1,
            bias_correction2=bias_correction2, adam_w_mode=adam_w_mode)
    if p.device.type != "cuda":
        raise ValueError(f"lamb_phase1 runs on cuda or cpu, not {p.device}")
    hyp = (beta1, beta2, beta3, eps, weight_decay, bias_correction1,
           bias_correction2)
    u = _launch(g, p, m, v, _scalar(grad_scale, p.device), hyp, adam_w_mode)
    return u, m, v


# --- the per-leaf steps ---------------------------------------------------

def f32(x) -> float:
    """``x`` rounded to fp32 (the JAX kernels' hyperparameter vector)."""
    return float(np.float32(x))


def one_minus(x) -> float:
    """``1 - x`` formed in fp32, as the JAX kernels form it."""
    return float(np.float32(1.0) - np.float32(x))


def check_buffers(what: str, g, state, lowp=None,
                  lowp_master: bool = False) -> Tuple[int, int]:
    """Raise unless ``state`` (the master first) are contiguous fp32
    buffers of one length on one device, ``g`` a contiguous gradient of
    that length in a dtype the kernels take, and ``lowp`` None or a
    contiguous bf16/fp16 buffer of that length: what the element-wise
    kernels read as flat arrays.  With ``lowp_master`` the master may
    also be a bf16/fp16 tensor stepped without a copy (``lowp`` None).
    Returns the length and the master's ``get_device()``.  (Called on
    the kernels' path only, where the master lies on a CUDA device:
    ``get_device()`` tells devices apart there, at a fraction of
    ``.device``'s cost.)"""
    p = state[0]
    n = p.numel()
    dev = p.get_device()
    low = lowp_master and p.dtype in _LOWP_TAKES and lowp is None
    ok = (p.dtype == torch.float32 or low) and p.is_contiguous()
    for t in state[1:]:
        ok = ok and t.dtype == torch.float32 and t.is_contiguous() and \
            t.numel() == n and t.get_device() == dev
    if not ok:
        raise ValueError(f"{what}: the master and state must be "
                         f"contiguous float32 buffers of {n} elements "
                         f"on {p.device}" + (
                             " (or the master a bf16/fp16 tensor with no "
                             "copy)" if lowp_master else ""))
    if g.dtype not in _G_TAKES or not g.is_contiguous() or \
            g.numel() != n or g.get_device() != dev:
        raise ValueError(f"{what}: g must be a contiguous {_G_TAKES} "
                         f"buffer of {n} elements on {p.device}")
    if lowp is not None and (lowp.dtype not in _LOWP_TAKES
                             or not lowp.is_contiguous()
                             or lowp.numel() != n
                             or lowp.get_device() != dev):
        raise ValueError(f"{what}: lowp must be a contiguous {_LOWP_TAKES} "
                         f"buffer of {n} elements on {p.device}")
    return n, dev


def sgd_step_reference(g, p, mom, lowp=None, *, lr, momentum, dampening,
                       weight_decay, nesterov=False, wd_after_momentum=False,
                       first_run):
    """Plain version of the SGD step (the ``_sgd_step_kernel`` math, in
    its order, one rounding an operation), updating ``p``, ``mom`` and
    ``lowp`` in place; returns them."""
    lr_, mo, omd, wd = (_scalar(x, p.device) for x in (
        f32(lr), f32(momentum), one_minus(dampening), f32(weight_decay)))
    gf = g.float()
    if not wd_after_momentum:
        gf = gf + wd * p
    mom_new = gf if first_run else mo * mom + omd * gf
    upd = gf + mo * mom_new if nesterov else mom_new
    if wd_after_momentum:
        upd = upd + wd * p
    p.copy_(p - lr_ * upd)
    mom.copy_(mom_new)
    if lowp is not None:
        lowp.copy_(p)
    return p, mom, lowp


def adam_step_reference(g, p, m, v, lowp=None, *, lr, beta1, beta2, eps,
                        weight_decay, bias_correction1, bias_correction2,
                        adam_w_mode=True):
    """Plain version of the Adam step (the ``_adam_step_kernel`` math, in
    its order, one rounding an operation), updating ``p``, ``m``, ``v``
    and ``lowp`` in place; returns them.  A bf16/fp16 ``p`` (no ``lowp``)
    is read into fp32 and rounded back once."""
    lr_, b1, omb1, b2, omb2, eps_, wd, bc1, bc2 = (
        _scalar(x, p.device) for x in (
            f32(lr), f32(beta1), one_minus(beta1), f32(beta2),
            one_minus(beta2), f32(eps), f32(weight_decay),
            f32(bias_correction1), f32(bias_correction2)))
    gf, pf = g.float(), p.float()
    if not adam_w_mode:
        gf = gf + wd * pf
    m_new = b1 * m + omb1 * gf
    v_new = b2 * v + omb2 * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps_)
    if adam_w_mode:
        upd = upd + wd * pf
    p.copy_(pf - lr_ * upd)
    m.copy_(m_new)
    v.copy_(v_new)
    if lowp is not None:
        lowp.copy_(p)
    return p, m, v, lowp


# The steps over a list of leaves: on CUDA tensors one launch of the leaf
# table kernel (``csrc/optim_step.cuh``) per dtype pair of (g, lowp) and
# table's worth of leaves, each launch counted; on CPU tensors the plain
# per-leaf versions in a loop.  The table is packed anew on every call
# from each buffer's ``data_ptr()``: amp's staged route hands over new
# gradient tensors every step.

# elements a block of the table kernels takes (a multiple of 4): one
# pass of a block's 256 threads, 4 vectors of 4 each; the fastest of 4096,
# 8192 and 16384 on the H100 over ResNet-50's leaves (PERF.md, row 19)
STEP_CHUNK = 4096

_CAPACITY = {}


def step_capacity(lib: str) -> int:
    """The leaves one launch of ``csrc/<lib>.cu``'s step takes (``lib``
    ``fused_sgd`` or ``fused_adam``): its table's size in the kernel's
    4 KB parameter block, asked of the built library once."""
    if lib not in _CAPACITY:
        name = {"fused_sgd": "sgd", "fused_adam": "adam"}[lib]
        _CAPACITY[lib] = getattr(_build.library(lib),
                                 f"apex_{name}_step_capacity")()
    return _CAPACITY[lib]


def _on_cpu_leaves(what: str, masters) -> bool:
    """True where every master lies on the CPU; False where the first
    lies on a CUDA device (each leaf's own check follows); raises on any
    other device or a mix with the CPU."""
    if not masters:
        return True
    kind = masters[0].device.type
    if kind == "cpu":
        if any(p.device.type != "cpu" for p in masters):
            raise ValueError(f"{what}: the leaves lie on more than one "
                             f"device")
        return True
    if kind != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not "
                         f"{masters[0].device}")
    return False


def _launch_leaves(what: str, lib_name: str, grads, states, lowps,
                   hyp, lowp_master: bool = False) -> None:
    """Check every leaf as :func:`check_buffers` does (raising on the
    first that fails), group the leaves by (g dtype, lowp dtype), pack each
    group's pointers and lengths into int64 rows, and launch
    ``apex_<what>_leaves`` once a table's worth of rows, counting each
    launch under ``what``.  ``lowp_master``: the master may be a bf16/fp16
    tensor (the groups keyed by its dtype too, whose code the entry takes
    last; their launches counted under ``<what>_lowp``)."""
    lists = (grads, *states, lowps)
    if len({len(x) for x in lists}) != 1:
        raise ValueError(f"{what}: {[len(x) for x in lists]} grads, "
                         f"masters, states and copies")
    if not grads:
        return
    dev = states[0][0].device
    index = dev.index if dev.type == "cuda" else -1
    groups = {}
    for leaf in zip(*lists):
        g, lowp = leaf[0], leaf[-1]
        n, on = check_buffers(what, g, leaf[1:-1], lowp, lowp_master)
        if on != index:
            raise ValueError(f"{what}: every leaf must lie on {dev}, not "
                             f"{leaf[1].device}")
        if n:
            row = [t.data_ptr() for t in leaf[:-1]]
            row += (0, n) if lowp is None else (lowp.data_ptr(), n)
            key = (g.dtype, None if lowp is None else lowp.dtype,
                   leaf[1].dtype)
            groups.setdefault(key, []).append(row)
    if not groups:
        return
    lib = _build.library(lib_name)
    fn = getattr(lib, f"apex_{what}_leaves")
    cap = step_capacity(lib_name)
    stream = _build.stream_ptr(dev)
    with torch.cuda.device(dev):
        for (gdt, ldt, pdt), rows in groups.items():
            table = np.array(rows, dtype=np.int64)
            ptrs = np.ascontiguousarray(table[:, :-1])
            ns = np.ascontiguousarray(table[:, -1])
            codes = (_build.dtype_code(gdt),
                     0 if ldt is None else _build.dtype_code(ldt))
            if lowp_master:
                codes += (_build.dtype_code(pdt),)
            for i in range(0, len(rows), cap):
                rc = fn(ptrs[i:].ctypes.data, ns[i:].ctypes.data,
                        min(cap, len(rows) - i), STEP_CHUNK, *hyp, *codes,
                        stream)
                _build.check(lib_name, rc, f"{what} kernel")
                bump(what if pdt == torch.float32 else f"{what}_lowp")


def sgd_step_leaves_reference(grads: Sequence[torch.Tensor],
                              masters: Sequence[torch.Tensor],
                              moms: Sequence[torch.Tensor],
                              lowps: Sequence[Optional[torch.Tensor]],
                              **hyp) -> None:
    """The plain SGD step over each leaf in turn."""
    for g, p, mom, lowp in zip(grads, masters, moms, lowps):
        sgd_step_reference(g, p, mom, lowp, **hyp)


def _sgd_leaves_launch(grads, masters, moms, lowps, *, lr, momentum,
                       dampening, weight_decay, nesterov, wd_after_momentum,
                       first_run) -> None:
    _launch_leaves("sgd_step", "fused_sgd", grads, (masters, moms), lowps,
                   (f32(lr), f32(momentum), one_minus(dampening),
                    f32(weight_decay), int(bool(first_run)),
                    int(bool(nesterov)), int(bool(wd_after_momentum))))


def sgd_step_leaves(grads: Sequence[torch.Tensor],
                    masters: Sequence[torch.Tensor],
                    moms: Sequence[torch.Tensor],
                    lowps: Sequence[Optional[torch.Tensor]], *, lr: float,
                    momentum: float, dampening: float, weight_decay: float,
                    nesterov: bool = False, wd_after_momentum: bool = False,
                    first_run: bool) -> None:
    """One momentum-SGD step over every leaf, in place: each fp32 master
    and its momentum updated, the model copy cast into its ``lowps`` entry
    (None where the master is the model copy).  ``first_run``: torch's
    first step, ``mom <- g``.  On CUDA tensors one launch a dtype pair and
    table (:func:`step_capacity` leaves)."""
    kw = dict(lr=lr, momentum=momentum, dampening=dampening,
              weight_decay=weight_decay, nesterov=nesterov,
              wd_after_momentum=wd_after_momentum, first_run=first_run)
    if _on_cpu_leaves("sgd_step_leaves", masters):
        sgd_step_leaves_reference(grads, masters, moms, lowps, **kw)
    else:
        _sgd_leaves_launch(grads, masters, moms, lowps, **kw)


def sgd_step(g: torch.Tensor, p: torch.Tensor, mom: torch.Tensor,
             lowp: Optional[torch.Tensor] = None, *, lr: float,
             momentum: float, dampening: float, weight_decay: float,
             nesterov: bool = False, wd_after_momentum: bool = False,
             first_run: bool):
    """One momentum-SGD step over one leaf (:func:`sgd_step_leaves` of
    one), in place.  Returns ``(p, mom, lowp)``."""
    sgd_step_leaves([g], [p], [mom], [lowp], lr=lr, momentum=momentum,
                    dampening=dampening, weight_decay=weight_decay,
                    nesterov=nesterov, wd_after_momentum=wd_after_momentum,
                    first_run=first_run)
    return p, mom, lowp


def adam_step_leaves_reference(grads: Sequence[torch.Tensor],
                               masters: Sequence[torch.Tensor],
                               ms: Sequence[torch.Tensor],
                               vs: Sequence[torch.Tensor],
                               lowps: Sequence[Optional[torch.Tensor]],
                               **hyp) -> None:
    """The plain Adam step over each leaf in turn."""
    for g, p, m, v, lowp in zip(grads, masters, ms, vs, lowps):
        adam_step_reference(g, p, m, v, lowp, **hyp)


def _adam_leaves_launch(grads, masters, ms, vs, lowps, *, lr, beta1, beta2,
                        eps, weight_decay, bias_correction1,
                        bias_correction2, adam_w_mode) -> None:
    _launch_leaves("adam_step", "fused_adam", grads, (masters, ms, vs),
                   lowps, (f32(lr), f32(beta1), one_minus(beta1), f32(beta2),
                           one_minus(beta2), f32(eps), f32(weight_decay),
                           f32(bias_correction1), f32(bias_correction2),
                           int(bool(adam_w_mode))), lowp_master=True)


def adam_step_leaves(grads: Sequence[torch.Tensor],
                     masters: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                     lowps: Sequence[Optional[torch.Tensor]], *, lr: float,
                     beta1: float, beta2: float, eps: float,
                     weight_decay: float, bias_correction1: float,
                     bias_correction2: float,
                     adam_w_mode: bool = True) -> None:
    """One Adam (``adam_w_mode=False``: L2) or AdamW step over every leaf,
    in place: each master and its fp32 moments updated, the model copy
    cast into its ``lowps`` entry (None where the master is the model
    copy).  A master is an fp32 tensor, or a bf16/fp16 parameter stepped
    without a master (its ``lowps`` entry None): fp32 arithmetic, the
    result rounded back into it.  On CUDA tensors one launch a (g, lowp,
    master) dtype lane and table (:func:`step_capacity` leaves)."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, bias_correction1=bias_correction1,
              bias_correction2=bias_correction2, adam_w_mode=adam_w_mode)
    if _on_cpu_leaves("adam_step_leaves", masters):
        adam_step_leaves_reference(grads, masters, ms, vs, lowps, **kw)
    else:
        _adam_leaves_launch(grads, masters, ms, vs, lowps, **kw)


def adam_step(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, lowp: Optional[torch.Tensor] = None, *,
              lr: float, beta1: float, beta2: float, eps: float,
              weight_decay: float, bias_correction1: float,
              bias_correction2: float, adam_w_mode: bool = True):
    """One Adam or AdamW step over one leaf (:func:`adam_step_leaves` of
    one), in place.  Returns ``(p, m, v, lowp)``."""
    adam_step_leaves([g], [p], [m], [v], [lowp], lr=lr, beta1=beta1,
                     beta2=beta2, eps=eps, weight_decay=weight_decay,
                     bias_correction1=bias_correction1,
                     bias_correction2=bias_correction2,
                     adam_w_mode=adam_w_mode)
    return p, m, v, lowp


# --- the optax-style update bodies ----------------------------------------
#
# Port of ``adam_update`` (:170, body ``_adam_kernel`` :148),
# ``adagrad_update`` (:253, ``_adagrad_kernel`` :242), ``novograd_update``
# (:323, ``_novograd_kernel`` :309) and ``sgd_update`` (:356, ``_sgd_kernel``
# :338): each takes the gradient ``g`` and the parameter ``p`` (fp32, bf16
# or fp16) and fp32 state over one flat buffer or one leaf, and returns
# new tensors — the delta in ``p``'s dtype and the new state — as the JAX
# functions return new arrays; nothing is updated in place.  On CUDA
# tensors each launches its body of ``csrc/fused_optim_update.cu`` or
# raises; on CPU tensors it runs its plain version.

def check_update_buffers(what: str, g, p, state) -> None:
    """Raise unless ``g`` and ``p`` are contiguous buffers of one length
    on one device in dtypes the update kernels take, and ``state`` are
    contiguous float32 buffers of that length there: what the update
    kernels read as flat arrays (the delta takes ``p``'s dtype)."""
    n = p.numel()
    for name, t in (("g", g), ("p", p)):
        if t.dtype not in _G_TAKES or not t.is_contiguous() or \
                t.numel() != n or t.device != p.device:
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{_G_TAKES} buffer of {n} elements on "
                             f"{p.device}")
    for t in state:
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.numel() != n or t.device != p.device:
            raise ValueError(f"{what}: the state must be contiguous float32 "
                             f"buffers of {n} elements on {p.device}")


def _update_launch(name: str, fn: str, g, p, state, outs, *hyp):
    """Check the buffers, launch ``fn`` of ``csrc/fused_optim_update.cu``
    on (g, p, state) -> (delta, new state) and count it; returns the new
    delta and state tensors."""
    check_update_buffers(name, g, p, state)
    delta = torch.empty_like(p)
    new = [torch.empty_like(t) for t in state[:outs]]
    lib = _build.library("fused_optim_update")
    with torch.cuda.device(p.device):
        rc = getattr(lib, fn)(
            g.data_ptr(), p.data_ptr(), *(t.data_ptr() for t in state),
            delta.data_ptr(), *(t.data_ptr() for t in new), p.numel(), *hyp,
            _build.dtype_code(g.dtype), _build.dtype_code(p.dtype),
            _build.stream_ptr(p.device))
    _build.check("fused_optim_update", rc, f"{name} kernel")
    bump(name)
    return (delta, *new)


def _on_cpu(what: str, p) -> bool:
    if p.device.type == "cpu":
        return True
    if p.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {p.device}")
    return False


@torch.no_grad()
def adam_update_reference(g, p, m, v, *, lr, beta1, beta2, eps,
                          weight_decay, bias_correction1, bias_correction2,
                          adam_w_mode=True):
    """Plain version of ``adam_update`` (the ``_adam_kernel`` math, in its
    order, one rounding an operation) -> ``(delta, m, v)``, all new."""
    nlr, b1, omb1, b2, omb2, eps_, wd, bc1, bc2 = (
        _scalar(x, p.device) for x in (
            -f32(lr), f32(beta1), one_minus(beta1), f32(beta2),
            one_minus(beta2), f32(eps), f32(weight_decay),
            f32(bias_correction1), f32(bias_correction2)))
    gf, pf = g.float(), p.float()
    if not adam_w_mode:
        gf = gf + wd * pf
    m_new = b1 * m + omb1 * gf
    v_new = b2 * v + omb2 * gf * gf
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps_)
    if adam_w_mode:
        u = u + wd * pf
    return (nlr * u).to(p.dtype), m_new, v_new


@torch.no_grad()
def adam_update(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, *, lr: float, beta1: float, beta2: float,
                eps: float, weight_decay: float, bias_correction1: float,
                bias_correction2: float, adam_w_mode: bool = True):
    """One Adam (``adam_w_mode=False``: L2) or AdamW update over one
    buffer -> ``(delta, m, v)``: the delta in ``p``'s dtype, new fp32
    moments."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, bias_correction1=bias_correction1,
              bias_correction2=bias_correction2, adam_w_mode=adam_w_mode)
    if _on_cpu("adam_update", p):
        return adam_update_reference(g, p, m, v, **kw)
    return _update_launch(
        "adam_update", "apex_adam_update", g, p, (m, v), 2, f32(lr),
        f32(beta1), one_minus(beta1), f32(beta2), one_minus(beta2), f32(eps),
        f32(weight_decay), f32(bias_correction1), f32(bias_correction2),
        int(bool(adam_w_mode)))


@torch.no_grad()
def adagrad_update_reference(g, p, h, *, lr, eps, weight_decay):
    """Plain version of ``adagrad_update`` (the ``_adagrad_kernel`` math)
    -> ``(delta, h)``, both new."""
    nlr, eps_, wd = (_scalar(x, p.device)
                     for x in (-f32(lr), f32(eps), f32(weight_decay)))
    gf = g.float() + wd * p.float()
    h_new = h + gf * gf
    return (nlr * gf / (torch.sqrt(h_new) + eps_)).to(p.dtype), h_new


@torch.no_grad()
def adagrad_update(g: torch.Tensor, p: torch.Tensor, h: torch.Tensor, *,
                   lr: float, eps: float, weight_decay: float):
    """One Adagrad update (L2 decay into g) over one buffer -> ``(delta,
    h)``: the delta in ``p``'s dtype, the new fp32 sum of squares."""
    if _on_cpu("adagrad_update", p):
        return adagrad_update_reference(g, p, h, lr=lr, eps=eps,
                                        weight_decay=weight_decay)
    return _update_launch("adagrad_update", "apex_adagrad_update", g, p,
                          (h,), 1, f32(lr), f32(eps), f32(weight_decay))


@torch.no_grad()
def novograd_update_reference(g, p, m, denom, *, lr, beta1, beta3,
                              weight_decay, bias_correction1):
    """Plain version of ``novograd_update`` (the ``_novograd_kernel``
    math) -> ``(delta, m)``, both new.  ``denom`` broadcasts against
    ``g``: the per-element buffer, or one tensor's 0-d denominator."""
    nlr, b1, b3, wd, bc1 = (_scalar(x, p.device) for x in (
        -f32(lr), f32(beta1), f32(beta3), f32(weight_decay),
        f32(bias_correction1)))
    scaled = g.float() / denom + wd * p.float()
    m_new = b1 * m + b3 * scaled
    return (nlr * m_new / bc1).to(p.dtype), m_new


@torch.no_grad()
def novograd_update(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                    denom_elem: torch.Tensor, *, lr: float, beta1: float,
                    beta3: float, weight_decay: float,
                    bias_correction1: float):
    """One NovoGrad update over one packed buffer -> ``(delta, m)``.  The
    per-tensor denominator (``sqrt(v / bc2) + eps`` of the tensor's scalar
    second moment) arrives broadcast into ``denom_elem``, one fp32 value
    an element, as JAX's caller builds it; ``beta3`` is taken as given
    (``1 - beta1`` formed by the caller, or 1)."""
    kw = dict(lr=lr, beta1=beta1, beta3=beta3, weight_decay=weight_decay,
              bias_correction1=bias_correction1)
    if _on_cpu("novograd_update", p):
        return novograd_update_reference(g, p, m, denom_elem, **kw)
    return _update_launch(
        "novograd_update", "apex_novograd_update", g, p, (m, denom_elem), 1,
        f32(lr), f32(beta1), f32(beta3), f32(weight_decay),
        f32(bias_correction1))


@torch.no_grad()
def sgd_update_reference(g, p, mom, *, lr, momentum, dampening,
                         weight_decay, nesterov=False,
                         wd_after_momentum=False, first_run):
    """Plain version of ``sgd_update`` (the ``_sgd_kernel`` math) ->
    ``(delta, mom)``, both new."""
    nlr, mo, omd, wd = (_scalar(x, p.device) for x in (
        -f32(lr), f32(momentum), one_minus(dampening), f32(weight_decay)))
    gf, pf = g.float(), p.float()
    if not wd_after_momentum:
        gf = gf + wd * pf
    mom_new = gf.clone() if first_run else mo * mom + omd * gf
    upd = gf + mo * mom_new if nesterov else mom_new
    if wd_after_momentum:
        upd = upd + wd * pf
    return (nlr * upd).to(p.dtype), mom_new


@torch.no_grad()
def sgd_update(g: torch.Tensor, p: torch.Tensor, mom: torch.Tensor, *,
               lr: float, momentum: float, dampening: float,
               weight_decay: float, nesterov: bool = False,
               wd_after_momentum: bool = False, first_run: bool):
    """One momentum-SGD update over one buffer -> ``(delta, mom)``.
    ``first_run``: torch's first step, ``mom <- g``."""
    kw = dict(lr=lr, momentum=momentum, dampening=dampening,
              weight_decay=weight_decay, nesterov=nesterov,
              wd_after_momentum=wd_after_momentum, first_run=first_run)
    if _on_cpu("sgd_update", p):
        return sgd_update_reference(g, p, mom, **kw)
    return _update_launch(
        "sgd_update", "apex_sgd_update", g, p, (mom,), 1, f32(lr),
        f32(momentum), one_minus(dampening), f32(weight_decay),
        int(bool(first_run)), int(bool(nesterov)),
        int(bool(wd_after_momentum)))
