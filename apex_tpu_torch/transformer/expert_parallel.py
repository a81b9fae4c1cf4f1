"""Switch/GShard mixture of experts on one device.

Port of the one-device part of ``apex_tpu/transformer/expert_parallel.py``:
the routers (:func:`top1_router`, :func:`top2_router`), the choice-major
capacity slotting (:func:`_dispatch_indices`), the unfused
:func:`moe_dispatch_combine`, the fused front :func:`moe_dispatch_combine_fused`
(routing, slotting and the buffer scatter in one call of
:func:`~apex_tpu_torch.ops.moe_routing.moe_route_dispatch`, row 18's
kernel on CUDA), and :class:`ExpertParallelMLP` with every expert local.

Capacity is JAX's, in Python floats: ``max(1, int(capacity_factor *
top_k * T / num_experts))`` with T every row handed in.  Routing
decisions of the fused and the unfused fronts are bit-identical.

Expert parallelism proper — experts sharded over a mesh axis, the
capacity-chunked all_to_all exchange (``a2a_chunks``), ``mesh_plan`` and
``plan=`` — is not ported: any ``axis_name`` other than None raises
:class:`NotImplementedError`.  A
``torch.Generator`` takes the place of a JAX key for the ``random``
second policy; ``u=`` feeds a draw made elsewhere instead.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.moe_routing import _fused, _softmax, moe_combine

__all__ = ["EXPERT_AXIS", "RouterOutput", "Top2RouterOutput", "top1_router",
           "top2_router", "router_logits", "moe_dispatch_combine",
           "moe_dispatch_combine_fused", "ExpertParallelMLP"]

# the JAX package's expert mesh axis name: its functions' default
EXPERT_AXIS = "expert"


def _local_only(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: experts sharded over a mesh axis "
            f"(the all_to_all exchange) are not ported (ROADMAP Queue 1 "
            f"item 8); pass axis_name=None to run every expert locally")


class RouterOutput(NamedTuple):
    expert_index: torch.Tensor    # (T,) int32 chosen expert per token
    gate: torch.Tensor            # (T,) fp32 chosen-expert probability
    load_balancing_loss: torch.Tensor  # () aux loss (Switch eq. 4)


class Top2RouterOutput(NamedTuple):
    expert_index: torch.Tensor    # (2, T) int32 chosen experts per token
    gate: torch.Tensor            # (2, T) fp32 normalized gates
    load_balancing_loss: torch.Tensor


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``x @ router`` in full fp32, whatever the float32 matmul precision
    is set to: routing is argmax over these, and TF32 would flip it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return x.float() @ router.float()
    finally:
        torch.set_float32_matmul_precision(prev)


def _aux(idx1, probs, e):
    frac = F.one_hot(idx1, e).float().mean(dim=0)
    return e * (frac * probs.mean(dim=0)).sum()


def top1_router(logits: torch.Tensor) -> RouterOutput:
    """Top-1 gating with the Switch load-balancing auxiliary loss."""
    probs = _softmax(logits)
    idx = probs.argmax(dim=-1)
    gate = probs.gather(1, idx[:, None])[:, 0]
    return RouterOutput(idx.to(torch.int32), gate,
                        _aux(idx, probs, logits.shape[-1]))


def top2_router(logits: torch.Tensor, second_policy: str = "all",
                rng: Optional[torch.Generator] = None, *,
                u: Optional[torch.Tensor] = None) -> Top2RouterOutput:
    """Top-2 gating (GShard Algorithm 1): each token's two most probable
    experts, gates renormalized over the pair; the aux loss over first
    choices.  ``second_policy="random"`` keeps the second choice iff
    ``u < 2 * gate2`` with ``u`` uniform from ``rng`` (or given as ``u``);
    a dropped second choice carries gate 0, claims no capacity slot and
    adds nothing to the combine."""
    if second_policy not in ("all", "random"):
        raise ValueError(f"second_policy must be 'all'|'random', got "
                         f"{second_policy!r}")
    if second_policy == "random" and rng is None and u is None:
        raise ValueError("second_policy='random' requires rng")
    probs = _softmax(logits)
    e = logits.shape[-1]
    idx1 = probs.argmax(dim=-1)
    gate1 = probs.gather(1, idx1[:, None])[:, 0]
    masked = probs * (1.0 - F.one_hot(idx1, e).to(probs.dtype))
    idx2 = masked.argmax(dim=-1)
    gate2 = masked.gather(1, idx2[:, None])[:, 0]
    denom = torch.clamp_min(gate1 + gate2, 1e-9)
    g1n, g2n = gate1 / denom, gate2 / denom
    if second_policy == "random":
        if u is None:
            u = torch.rand(g2n.shape, generator=rng, device=logits.device)
        # no gradient through the threshold: a dispatch decision
        keep2 = u.float() < (2.0 * g2n).detach()
        g2n = torch.where(keep2, g2n, torch.zeros_like(g2n))
    return Top2RouterOutput(torch.stack([idx1, idx2]).to(torch.int32),
                            torch.stack([g1n, g2n]), _aux(idx1, probs, e))


def _dispatch_indices(expert_index: torch.Tensor, num_experts: int,
                      capacity: int, valid: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position of each entry within its expert's capacity slots:
    ``(slot, keep)``, slot clipped to [0, capacity) and keep False where
    the entry overflowed or ``valid`` is False (such entries claim no
    slot).  Pure cumsum arithmetic."""
    one_hot = F.one_hot(expert_index.long(), num_experts)
    if valid is not None:
        one_hot = one_hot * valid.long()[:, None]
    position = one_hot.cumsum(dim=0) * one_hot                # 1-based
    slot = position.sum(dim=1) - 1
    keep = (slot >= 0) & (slot < capacity)
    return slot.clamp(0, capacity - 1).to(torch.int32), keep


def _capacity(capacity_factor: float, k: int, t: int, e: int) -> int:
    return max(1, int(capacity_factor * k * t / e))


def _exchange_and_combine(buf, expert_fn, idx, gates, slot, keep, axis_name,
                          out_dtype) -> torch.Tensor:
    """The local exchange tail shared by both fronts: every expert on this
    device, then the gate-weighted combine."""
    _local_only(axis_name)
    return moe_combine(expert_fn(buf), idx, slot, keep, gates,
                       out_dtype=out_dtype)


def moe_dispatch_combine(x: torch.Tensor, router, expert_fn: Callable,
                         num_experts: int, capacity_factor: float = 1.25,
                         axis_name: Optional[str] = EXPERT_AXIS
                         ) -> torch.Tensor:
    """Dispatch the (T, H) tokens to experts, apply ``expert_fn`` to the
    (E, capacity, H) buffer, combine -> (T, H).  ``router`` is top-1
    (``(T,)`` index and gate) or top-k (``(k, T)``): the k choices share
    the capacity, first choices first (choice-major)."""
    _local_only(axis_name)
    t, h = x.shape
    idx = router.expert_index.reshape(-1, t)
    gates = router.gate.reshape(-1, t)
    k = idx.shape[0]
    capacity = _capacity(capacity_factor, k, t, num_experts)
    slot, keep = _dispatch_indices(idx.reshape(-1), num_experts, capacity,
                                   valid=gates.reshape(-1) > 0.0)
    xk = x[None].expand(k, t, h).reshape(k * t, h)
    buf = torch.zeros((num_experts, capacity, h), dtype=x.dtype,
                      device=x.device).index_put(
        (idx.reshape(-1).long(), slot.long()),
        torch.where(keep[:, None], xk, torch.zeros_like(xk)), accumulate=True)
    return _exchange_and_combine(buf, expert_fn, idx, gates, slot, keep,
                                 axis_name, x.dtype)


def moe_dispatch_combine_fused(
        x: torch.Tensor, logits: torch.Tensor, expert_fn: Callable,
        num_experts: int, capacity_factor: float = 1.25,
        axis_name: Optional[str] = EXPERT_AXIS, top_k: int = 1,
        second_policy: str = "all", rng: Optional[torch.Generator] = None,
        *, u: Optional[torch.Tensor] = None, plain: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused front: softmax, top-k, capacity slotting and the buffer
    scatter in one :func:`~apex_tpu_torch.ops.moe_routing.
    moe_route_dispatch` (row 18's kernel on CUDA), then the same local
    exchange as :func:`moe_dispatch_combine`.  Returns ``(y, aux_loss)``.
    ``u`` is the ``random`` policy's draw given directly; ``plain`` routes
    through the plain version whatever the device (the oracle
    configuration of the serving forward)."""
    from ..ops.moe_routing import moe_route_dispatch_reference

    _local_only(axis_name)
    t = x.shape[0]
    capacity = _capacity(capacity_factor, top_k, t, num_experts)
    if top_k == 2 and second_policy == "random" and u is None:
        if rng is None:
            raise ValueError("second_policy='random' requires rng")
        u = torch.rand(t, generator=rng, device=x.device)
    route = moe_route_dispatch_reference if plain else _fused
    rd = route(x, logits, u, capacity=capacity, top_k=top_k,
               second_policy=second_policy)
    y = _exchange_and_combine(rd.buf, expert_fn, rd.expert_index, rd.gate,
                              rd.slot, rd.keep, axis_name, x.dtype)
    return y, rd.load_balancing_loss


class ExpertParallelMLP:
    """Switch-style MoE FFN, every expert on this device.

    Functional container, as in JAX (params an explicit dict)::

        layer = ExpertParallelMLP(hidden, ffn_hidden, num_experts,
                                  axis_name=None)
        params = layer.init(generator)        # experts stacked on dim 0
        y, aux = layer.apply(params, x)

    ``fused_dispatch`` (default True, JAX's flag default) routes through
    row 18's fused front; False through the routers and
    :func:`_dispatch_indices`.  The expert MLP is fp32 throughout, gelu
    the tanh approximation (``jax.nn.gelu``'s default)."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 num_experts: int, capacity_factor: float = 1.25,
                 axis_name: Optional[str] = EXPERT_AXIS,
                 router: str = "top1", second_policy: str = "all",
                 fused_dispatch: Optional[bool] = None):
        if router not in ("top1", "top2"):
            raise ValueError(f"router must be top1|top2, got {router!r}")
        if second_policy not in ("all", "random"):
            raise ValueError(f"second_policy must be 'all'|'random', "
                             f"got {second_policy!r}")
        _local_only(axis_name)
        self.hidden_size = hidden_size
        self.ffn_hidden_size = ffn_hidden_size
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name
        self.router = router
        self.second_policy = second_policy
        self.fused_dispatch = True if fused_dispatch is None \
            else bool(fused_dispatch)

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Seeded fp32 parameters: router 0.02·randn (H, E); He-normal
        expert stacks wi (E, H, F), wo (E, F, H)."""
        e, h, f = self.num_experts, self.hidden_size, self.ffn_hidden_size

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device)

        return {"router": randn(h, e) * 0.02,
                "wi": randn(e, h, f) * (2.0 / h) ** 0.5,
                "wo": randn(e, f, h) * (2.0 / f) ** 0.5}

    def apply(self, params: dict, x: torch.Tensor,
              rng: Optional[torch.Generator] = None, *,
              u: Optional[torch.Tensor] = None):
        """(T, H) -> ``((T, H), aux_loss)``.  ``rng`` (or the draw ``u``)
        is required when ``second_policy='random'``."""
        logits = router_logits(x, params["router"])

        def expert_fn(buf):                   # (E, rows, H)
            hid = F.gelu(torch.bmm(buf.float(), params["wi"]),
                         approximate="tanh")
            return torch.bmm(hid, params["wo"]).to(buf.dtype)

        k = 2 if self.router == "top2" else 1
        if self.fused_dispatch:
            return moe_dispatch_combine_fused(
                x, logits, expert_fn, self.num_experts,
                capacity_factor=self.capacity_factor,
                axis_name=self.axis_name, top_k=k,
                second_policy=self.second_policy, rng=rng, u=u)
        router = (top2_router(logits, self.second_policy, rng, u=u)
                  if k == 2 else top1_router(logits))
        y = moe_dispatch_combine(x, router, expert_fn, self.num_experts,
                                 capacity_factor=self.capacity_factor,
                                 axis_name=self.axis_name)
        return y, router.load_balancing_loss
