"""Fused MoE routing and capacity dispatch: the CUDA kernel and its plain
version.

Port of ``apex_tpu/ops/moe_routing.py`` (row 18 of the kernel table,
``_route_dispatch_pallas`` and its twin ``moe_route_dispatch_reference``).
From ``x`` (T, H) tokens and ``logits`` (T, E) router scores it computes,
bit for bit in its integer outputs:

* the fp32 softmax over E of each token's logits (max-subtracted ``exp``,
  the fp32 sum, the divide);
* top-1 (Switch) or top-2 (GShard Algorithm 1): the argmax over the
  probabilities, lowest index on ties; for top 2 the second argmax over
  ``probs * (1 - onehot(idx1))`` and both gates renormalized over
  ``max(g1 + g2, 1e-9)``; under ``second_policy="random"`` the second
  choice is kept iff ``u < 2 * g2n`` and a dropped one gets gate 0;
* choice-major slotting: all first choices in token order, then all
  second choices, each claiming the next slot of its expert; a gate-0
  choice claims none; ``keep = slot < capacity`` and the slot is clipped
  to ``capacity - 1``;
* the zero-filled (E, capacity, H) dispatch buffer holding each kept
  token row in x's dtype;
* the Switch/GShard auxiliary loss ``E * sum(frac * mean_prob)`` over
  first choices.

:func:`moe_route_dispatch` launches ``csrc/moe_routing.cu`` on CUDA
tensors (or raises) and runs :func:`moe_route_dispatch_reference` on CPU
tensors; there is no other switch.  It is differentiable in ``x`` and
``logits`` through :class:`MoERouteDispatchFunction`, JAX's custom VJP:
the forward is the kernel, the backward differentiates the plain version
at the saved ``(x, logits, u)`` (the routing decisions are bit-identical,
so the plain version's gradient is the kernel's).  Where no input
requires grad (the serve), the call skips the Function: one CUDA launch at
T <= 32, two above, and a scratch kept across calls.

``u``, the (T,) uniform draw of the ``random`` policy, comes from the
caller's ``torch.Generator``; :func:`_fused` takes it explicitly, so that
another generator's draw (JAX's threefry, in the tests) can be fed in.
:func:`moe_combine`, the gate-weighted gather back to (T, H), is plain
torch, as JAX keeps it in jnp.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .._autocast_ctx import opaque
from ._counts import bump
from .layer_norm import _needs_grad

__all__ = ["RouteDispatch", "MoERouteDispatchFunction", "moe_route_dispatch",
           "moe_route_dispatch_reference", "moe_combine"]

_X_TAKES = (torch.float32, torch.bfloat16, torch.float16)
_TOK_PER_BLOCK = 32          # tokens a route block takes (the kernel's)
# a route block keeps each of its 32 tokens' probabilities in shared
# memory (32 x E x 4 bytes, 128 KB at 1024: within the card's 227 KB)
MAX_EXPERTS = 1024


class RouteDispatch(NamedTuple):
    """Everything the combine (and the router loss) needs downstream."""

    buf: torch.Tensor             # (E, capacity, H) dispatched tokens
    expert_index: torch.Tensor    # (k, T) int32 chosen expert per choice
    gate: torch.Tensor            # (k, T) fp32 gates (top-2: renormalized)
    slot: torch.Tensor            # (k*T,) int32 capacity slot, clipped
    keep: torch.Tensor            # (k*T,) bool, False = overflow/no dispatch
    load_balancing_loss: torch.Tensor  # () fp32 aux loss


def _check_args(x, logits, capacity, top_k, second_policy):
    if x.dim() != 2 or logits.dim() != 2 or logits.shape[0] != x.shape[0]:
        raise ValueError(f"x (T, H) / logits (T, E) mismatch: "
                         f"{tuple(x.shape)} vs {tuple(logits.shape)}")
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1|2, got {top_k}")
    if second_policy not in ("all", "random"):
        raise ValueError(f"second_policy must be 'all'|'random', got "
                         f"{second_policy!r}")


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """fp32 softmax over the last axis, written out as the kernel computes
    it: max-subtracted ``exp``, the fp32 sum, the divide."""
    z = logits.float()
    ez = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return ez / ez.sum(dim=-1, keepdim=True)


def moe_route_dispatch_reference(x: torch.Tensor, logits: torch.Tensor,
                                 u: Optional[torch.Tensor] = None, *,
                                 capacity: int, top_k: int = 1,
                                 second_policy: str = "all"
                                 ) -> RouteDispatch:
    """Plain version (JAX's jnp twin): the ``top1_router`` /
    ``top2_router`` math, the ``_dispatch_indices`` cumsum, a scatter-add
    into the zero buffer.  ``u``: the (T,) uniform draw, needed for
    ``second_policy="random"``.  Differentiable in ``x`` and ``logits``."""
    t, h = x.shape
    e = logits.shape[-1]
    probs = _softmax(logits)
    idx1 = probs.argmax(dim=-1)
    gate1 = probs.gather(1, idx1[:, None])[:, 0]
    if top_k == 2:
        masked = probs * (1.0 - F.one_hot(idx1, e).to(probs.dtype))
        idx2 = masked.argmax(dim=-1)
        gate2 = masked.gather(1, idx2[:, None])[:, 0]
        denom = torch.clamp_min(gate1 + gate2, 1e-9)
        g1n, g2n = gate1 / denom, gate2 / denom
        if second_policy == "random":
            if u is None:
                raise ValueError("second_policy='random' requires the "
                                 "uniform draw u")
            # the Bernoulli draw is a dispatch decision, not a gate
            # transformation (GShard): no gradient through the threshold
            keep2 = u.float() < (2.0 * g2n).detach()
            g2n = torch.where(keep2, g2n, torch.zeros_like(g2n))
        idx = torch.stack([idx1, idx2])
        gates = torch.stack([g1n, g2n])
    else:
        idx = idx1[None]
        gates = gate1[None]
    # aux loss over the FIRST choice (the GShard load estimator)
    frac = F.one_hot(idx1, e).float().mean(dim=0)
    aux = e * (frac * probs.mean(dim=0)).sum()

    valid = gates.reshape(-1) > 0.0
    one_hot = F.one_hot(idx.reshape(-1), e) * valid.long()[:, None]
    position = one_hot.cumsum(dim=0) * one_hot            # 1-based
    slot = position.sum(dim=1) - 1
    keep = (slot >= 0) & (slot < capacity)
    slot = slot.clamp(0, capacity - 1)

    k = idx.shape[0]
    xk = x[None].expand(k, t, h).reshape(k * t, h)
    rows = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    buf = torch.zeros((e, capacity, h), dtype=x.dtype, device=x.device)
    buf = buf.index_put((idx.reshape(-1), slot), rows, accumulate=True)
    return RouteDispatch(buf=buf, expert_index=idx.to(torch.int32),
                         gate=gates, slot=slot.to(torch.int32), keep=keep,
                         load_balancing_loss=aux)


def _scratch_words(t: int, e: int, top_k: int) -> int:
    """int32 words of the launch's scratch (``csrc/moe_routing.cu``'s
    rule): none at T <= 32, which routes in the dispatch launch itself;
    else the ranks (top_k * T), the counts (top_k * nb * E) and the fp32
    probability sums (nb * E) of nb = ceil(T / 32) route blocks."""
    if t <= _TOK_PER_BLOCK:
        return 0
    nb = -(-t // _TOK_PER_BLOCK)
    return top_k * t + top_k * nb * e + nb * e


# (device index, stream handle) -> the launches' int32 scratch, kept
# across calls and grown when too small: the stream orders each call's use
# of it after the last one's
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (dev.index, stream)
    w = _WORKSPACE.get(key)
    if w is None or w.numel() < words:
        w = torch.empty(words, dtype=torch.int32, device=dev)
        _WORKSPACE[key] = w
    return w


def _on_device(dev: torch.device):
    """A switch to the CUDA device ``dev`` where it is not the current one
    already (the launch goes to the current device)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch(x, logits, u, capacity, top_k, random):
    t, h = x.shape
    e = logits.shape[1]
    if x.dtype not in _X_TAKES or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {_X_TAKES} (T, H) tensor")
    if e > MAX_EXPERTS:
        raise ValueError(f"{e} experts: the kernel takes at most "
                         f"{MAX_EXPERTS}")
    for name, a in (("logits", logits), ("u", u)):
        if a is not None and (a.dtype != torch.float32 or
                              not a.is_contiguous() or a.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {x.device}")
    dev = x.device
    lib = _build.library("moe_routing")
    # one allocation an output (``new_empty``, the cheapest form): on the
    # card's host a view costs as much as an allocation, and a
    # dtype-reinterpreting view chain more
    kt = top_k * t
    idx = x.new_empty((top_k, t), dtype=torch.int32)
    gate = x.new_empty((top_k, t), dtype=torch.float32)
    slot = x.new_empty(kt, dtype=torch.int32)
    keep = x.new_empty(kt, dtype=torch.bool)
    aux = x.new_empty((), dtype=torch.float32)
    buf = x.new_empty((e, capacity, h))
    stream = _build.stream_ptr(dev)
    words = _scratch_words(t, e, top_k)
    scratch = _workspace(dev, stream, words).data_ptr() if words else None
    with _on_device(dev):
        rc = lib.apex_moe_route_dispatch(
            x.data_ptr(), logits.data_ptr(),
            u.data_ptr() if u is not None else None, idx.data_ptr(),
            gate.data_ptr(), slot.data_ptr(), keep.data_ptr(), aux.data_ptr(),
            buf.data_ptr(), scratch, t, h, e, capacity, top_k, int(random),
            x.element_size(), stream)
    _build.check("moe_routing", rc, "moe_route_dispatch kernel")
    bump("moe_route_dispatch")
    return RouteDispatch(buf=buf, expert_index=idx, gate=gate, slot=slot,
                         keep=keep, load_balancing_loss=aux)


def _route_dispatch(x, logits, u, capacity, top_k, second_policy):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return moe_route_dispatch_reference(x, logits, u, capacity=capacity,
                                            top_k=top_k,
                                            second_policy=second_policy)
    if x.device.type != "cuda":
        raise ValueError(f"moe_route_dispatch runs on cuda or cpu, not "
                         f"{x.device}")
    random = top_k == 2 and second_policy == "random"
    return _launch(x.contiguous(), logits.float().contiguous(),
                   u.float().contiguous() if random else None, capacity,
                   top_k, random)


class MoERouteDispatchFunction(torch.autograd.Function):
    """Route + dispatch under autograd (JAX's ``_fused`` custom VJP): the
    forward is the kernel (the plain version on the CPU); the backward
    differentiates the plain version at the saved ``(x, logits, u)``.  The
    integer outputs are not differentiable."""

    @staticmethod
    def forward(ctx, x, logits, u, capacity, top_k, second_policy):
        rd = _route_dispatch(x, logits, u, capacity, top_k, second_policy)
        ctx.save_for_backward(x, logits, u)
        ctx.cfg = dict(capacity=capacity, top_k=top_k,
                       second_policy=second_policy)
        ctx.mark_non_differentiable(rd.expert_index, rd.slot, rd.keep)
        ctx.set_materialize_grads(False)
        return tuple(rd)

    @staticmethod
    def backward(ctx, dbuf, _didx, dgate, _dslot, _dkeep, daux):
        x, logits, u = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            ll = logits.detach().requires_grad_()
            ref = moe_route_dispatch_reference(xx, ll, u, **ctx.cfg)
            pairs = [(o, g) for o, g in ((ref.buf, dbuf), (ref.gate, dgate),
                                         (ref.load_balancing_loss, daux))
                     if g is not None]
            if not pairs:
                return None, None, None, None, None, None
            dx, dl = torch.autograd.grad([o for o, _ in pairs], (xx, ll),
                                         [g for _, g in pairs],
                                         allow_unused=True)
        return dx, dl, None, None, None, None


@opaque
def _fused(x: torch.Tensor, logits: torch.Tensor,
           u: Optional[torch.Tensor], *, capacity: int, top_k: int = 1,
           second_policy: str = "all") -> RouteDispatch:
    """:func:`moe_route_dispatch` with the ``random`` policy's (T,)
    uniform draw ``u`` given (None for the other policies).  When autograd
    records and x or logits requires grad, it is
    :class:`MoERouteDispatchFunction`; else the kernel (or the plain
    version) alone, with no graph.  The choice reads only the tensors'
    flags, so it is the same on both devices."""
    _check_args(x, logits, capacity, top_k, second_policy)
    if top_k == 2 and second_policy == "random" and u is None:
        raise ValueError("second_policy='random' requires rng")
    if _needs_grad(x, logits):
        return RouteDispatch(*MoERouteDispatchFunction.apply(
            x, logits, u, int(capacity), int(top_k), second_policy))
    return _route_dispatch(x, logits, u, int(capacity), int(top_k),
                           second_policy)


@opaque
def moe_route_dispatch(x: torch.Tensor, logits: torch.Tensor, *,
                       capacity: int, top_k: int = 1,
                       second_policy: str = "all",
                       rng: Optional[torch.Generator] = None
                       ) -> RouteDispatch:
    """Fused route + dispatch: ``x`` (T, H) tokens, ``logits`` (T, E)
    router scores -> :class:`RouteDispatch`.

    ``rng`` (a ``torch.Generator`` on x's device) is required only for
    ``top_k=2`` with ``second_policy="random"``: the (T,) uniform draw
    happens here, so kernel and plain version consume the same numbers.
    Differentiable in ``x`` and ``logits``."""
    u = None
    if top_k == 2 and second_policy == "random":
        if rng is None:
            raise ValueError("second_policy='random' requires rng")
        u = torch.rand(x.shape[0], generator=rng, device=x.device)
    return _fused(x, logits, u, capacity=capacity, top_k=top_k,
                  second_policy=second_policy)


def moe_combine(out: torch.Tensor, expert_index: torch.Tensor,
                slot: torch.Tensor, keep: torch.Tensor, gate: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Gather each choice's slot output from the expert result buffer
    ``out`` (E, capacity, H), weight it by its gate (dropped choices
    contribute 0), sum over choices -> (T, H) in ``out_dtype`` (out's
    dtype by default).  Plain torch, as JAX keeps it in jnp."""
    k, t = expert_index.shape
    tok = out[expert_index.reshape(-1).long(), slot.long()]    # (k*T, H)
    g = torch.where(keep, gate.reshape(-1),
                    torch.zeros_like(gate.reshape(-1))).float()
    y = (tok.float() * g[:, None]).reshape(k, t, -1).sum(dim=0)
    return y.to(out_dtype if out_dtype is not None else out.dtype)
