"""Activation checkpointing with dropout replayed exactly.

Port of ``apex_tpu/transformer/tensor_parallel/random.py:104-138``
(``CHECKPOINT_POLICIES`` and ``checkpoint``) on PyTorch's
``torch.utils.checkpoint`` (non-reentrant):

* ``full`` saves nothing of the wrapped function but its inputs and
  recomputes the rest in the backward (JAX's ``nothing_saveable``);
* ``dots`` saves the outputs of the matrix products, ``aten.mm``,
  ``addmm``, ``bmm`` and ``baddbmm``, and recomputes the rest (JAX's
  ``dots_saveable``); ``dots_with_no_batch_dims`` saves only the
  products without a batch dimension, ``mm`` and ``addmm``: the
  linears, not the attention's score and context products (JAX's
  ``dots_with_no_batch_dims_saveable``).  Both are selective
  checkpointing (``create_selective_checkpoint_contexts``);
* ``all_but_ffn_wide`` saves everything but the two 4h-wide MLP
  intermediates JAX tags ``ffn_wide`` (``apex_tpu/transformer/
  layers.py:75-76``): the function runs as it is, and
  :class:`~apex_tpu_torch.transformer.layers.ParallelMLP`, seeing
  :func:`ffn_wide_recompute`, checkpoints its own body whole, so
  neither the h->4h output nor the activation is kept.

JAX replays dropout exactly because its keys are values.  The port's
randomness lives in explicit generators (a
:class:`~apex_tpu_torch.transformer.layers.DropoutRNG`'s CPU generator
for the E kernels' seeds and its device generator for the Bernoulli
masks), which ``preserve_rng_state`` does not cover.  So
:func:`checkpoint` takes every ``DropoutRNG`` and ``torch.Generator``
among the arguments, snapshots their states as the forward starts,
sets them back to that snapshot for the recompute, and afterwards
restores the states they held just before it: the recompute draws the
forward's masks and seeds, and the next forward draws what it would
have drawn without checkpointing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch
from torch.utils import checkpoint as _ckpt

__all__ = ["CHECKPOINT_POLICIES", "checkpoint", "ffn_wide_recompute"]

_aten = torch.ops.aten
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _DOTS_NO_BATCH | {_aten.bmm.default, _aten.baddbmm.default}


def _save_ops(ops) -> Callable:
    """A selective-checkpoint policy saving the outputs of ``ops``."""
    def policy(ctx, op, *args, **kwargs):
        return _ckpt.CheckpointPolicy.MUST_SAVE if op in ops \
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


#: the policies by name: a selective-checkpoint policy function, or None
#: where the policy is not a selective one (``full`` saves nothing,
#: ``all_but_ffn_wide`` checkpoints the MLP's body)
CHECKPOINT_POLICIES = {
    "full": None,
    "dots": _save_ops(_DOTS),
    "dots_with_no_batch_dims": _save_ops(_DOTS_NO_BATCH),
    "all_but_ffn_wide": None,
}

_FFN_WIDE = [False]


def ffn_wide_recompute() -> bool:
    """True inside a forward that :func:`checkpoint` runs under
    ``all_but_ffn_wide``: the MLP checkpoints its 4h-wide body."""
    return _FFN_WIDE[0]


def check_policy(policy: str) -> str:
    """``policy`` itself, or ``ValueError`` if it is not a key of
    :data:`CHECKPOINT_POLICIES`."""
    if policy not in CHECKPOINT_POLICIES:
        raise ValueError(f"unknown checkpoint_policy {policy!r}; expected "
                         f"one of {sorted(CHECKPOINT_POLICIES)}")
    return policy


def _generators(args, kwargs) -> List[torch.Generator]:
    """The generators a call may draw from: each ``torch.Generator`` and
    both of each dropout RNG's among the arguments."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Generator):
            out.append(a)
        elif hasattr(a, "seeds") and hasattr(a, "masks"):
            out.extend((a.seeds, a.masks))
    return out


def _replay_contexts(gens: List[torch.Generator]):
    """``(forward, recompute)`` context managers: the forward's snapshot
    of ``gens``, set again for the recompute, then the states before the
    recompute put back."""
    snap = []

    @contextlib.contextmanager
    def forward():
        snap[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, snap):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return forward(), recompute()


def _context_fn(gens, policy_fn):
    """``context_fn`` for ``torch.utils.checkpoint``: the replay of
    ``gens``, joined by the selective-checkpoint contexts of
    ``policy_fn`` where there is one."""
    def make():
        fwd, rec = _replay_contexts(gens)
        if policy_fn is None:
            return fwd, rec
        sac_fwd, sac_rec = _ckpt.create_selective_checkpoint_contexts(
            policy_fn)
        return _both(fwd, sac_fwd), _both(rec, sac_rec)
    return make


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def _run(fn, args, kwargs, policy: str):
    if policy == "all_but_ffn_wide":
        prev, _FFN_WIDE[0] = _FFN_WIDE[0], True
        try:
            return fn(*args, **kwargs)
        finally:
            _FFN_WIDE[0] = prev
    gens = _generators(args, kwargs)
    return _ckpt.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=_context_fn(gens, CHECKPOINT_POLICIES[policy]), **kwargs)


def checkpoint(fn: Callable, *args, policy: Optional[str] = "full",
               **kwargs):
    """Activation checkpointing (ref: ``CheckpointFunction``,
    ``random.py:224-290``): ``checkpoint(fn, *args)`` runs ``fn`` now,
    keeping only what ``policy`` saves and recomputing the rest in the
    backward with every generator among the arguments replayed;
    ``checkpoint(fn)`` returns the checkpointed function.  ``policy`` (a
    key of :data:`CHECKPOINT_POLICIES`, None for ``full``) is
    keyword-only; an unknown one raises ``ValueError``."""
    policy = check_policy(policy or "full")
    if not args and not kwargs:
        return lambda *a, **k: _run(fn, a, k, policy)
    return _run(fn, args, kwargs, policy)
