"""Packing metadata and flat buffers over an ordered sequence of tensors.

Port of the grouping half of ``apex_tpu/ops/multi_tensor.py`` — the layout
every optimizer ``update`` works on: leaves grouped per dtype (and, with
``split_direct``, each leaf of at least :data:`DIRECT_MIN_ELEMS` elements
its own *direct* group, processed in its native shape and never copied),
packed groups laid out in one flat buffer with each leaf's start rounded
up to ``align`` elements, zero-filled gaps, padded to a multiple of
``_PAD_TO`` and chunked at :data:`PACK_MAX_ELEMS`.  Offsets, padded
lengths and chunk boundaries are JAX's, so optimizer state built by one
package is laid out as the other's.

The port takes the leaves as a sequence.  A JAX pytree flattens a dict in
sorted-key order, so a caller holding the same parameters as a JAX dict
hands the port its leaves in that order to get the same layout.
:data:`DIRECT_MIN_ELEMS` and :data:`PACK_MAX_ELEMS` are module constants
read at every call (JAX reads the first from the flag
``APEX_TPU_DIRECT_MIN_ELEMS``, default 0: every leaf direct); a caller
that wants packed groups sets the constant.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

LANE = 128
_PAD_TO = 8 * LANE

# leaves of at least this many elements form their own direct group under
# compute_metas(split_direct=True); 0: every leaf (JAX's default)
DIRECT_MIN_ELEMS = 0
# the largest packed group of a split_direct grouping, in elements
PACK_MAX_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class FlatMeta:
    """Static packing metadata for one group (JAX's ``FlatMeta``, with the
    number of leaves in place of the treedef)."""

    n_leaves: int
    leaf_indices: Tuple[int, ...]      # positions in the leaf sequence
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int                          # unpadded element count
    padded: int                         # padded to _PAD_TO
    dtype: torch.dtype
    direct: bool = False                # one leaf in its native shape


def _group_leaves(leaves, split_direct: bool, direct_min: Optional[int]):
    """Leaf indices by (dtype, bucket), in order of first appearance:
    bucket None for the one group a dtype without ``split_direct``, a
    chunk number for a packed chunk, ("direct", i) for leaf i alone."""
    threshold = DIRECT_MIN_ELEMS if direct_min is None else direct_min
    groups: dict = {}
    if not split_direct:
        for i, leaf in enumerate(leaves):
            groups.setdefault((leaf.dtype, None), []).append(i)
        return groups
    fill: dict = {}  # dtype -> (chunk, elements in it)
    for i, leaf in enumerate(leaves):
        size = leaf.numel()
        if size >= threshold:
            groups[(leaf.dtype, ("direct", i))] = [i]
            continue
        chunk, used = fill.get(leaf.dtype, (0, 0))
        if used and used + size > PACK_MAX_ELEMS:
            chunk, used = chunk + 1, 0
        fill[leaf.dtype] = (chunk, used + size)
        groups.setdefault((leaf.dtype, chunk), []).append(i)
    return groups


def compute_metas(leaves: Sequence[torch.Tensor], align: int = 1,
                  split_direct: bool = False,
                  direct_min: Optional[int] = None) -> List[FlatMeta]:
    """Packing metadata for ``leaves`` (shapes and dtypes only).

    ``align`` rounds each leaf's start up to a multiple of ``align``
    elements (NovoGrad packs with ``align=LANE``); ``split_direct`` gives
    leaves of at least :data:`DIRECT_MIN_ELEMS` (or ``direct_min``)
    elements their own direct group and chunks the rest at
    :data:`PACK_MAX_ELEMS`."""
    metas = []
    for (dtype, bucket), idxs in _group_leaves(
            leaves, split_direct, direct_min).items():
        shapes = tuple(tuple(leaves[i].shape) for i in idxs)
        sizes = tuple(leaves[i].numel() for i in idxs)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += -(-s // align) * align
        padded = max(_PAD_TO, -(-off // _PAD_TO) * _PAD_TO)
        metas.append(FlatMeta(
            len(leaves), tuple(idxs), shapes, sizes, tuple(offsets), off,
            padded, dtype,
            direct=isinstance(bucket, tuple) and bucket[0] == "direct"))
    return metas


def is_direct(meta: FlatMeta) -> bool:
    """A direct group: one leaf processed in its native shape."""
    return meta.direct


def pack(leaves: Sequence[torch.Tensor], metas: Sequence[FlatMeta],
         dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """One flat buffer a group of ``metas`` (``metas`` from the parameters,
    so gradients pack in their layout): the leaves at their offsets, the
    gaps and the padding zero.  The buffer is in ``dtype``, else in the
    leaves' own (promoted) dtype."""
    out = []
    for meta in metas:
        group = [leaves[i] for i in meta.leaf_indices]
        dt = dtype or functools.reduce(torch.promote_types,
                                       [t.dtype for t in group])
        flat = torch.empty(meta.padded, dtype=dt, device=group[0].device)
        pos = 0
        for leaf, o, s in zip(group, meta.offsets, meta.sizes):
            if o > pos:
                flat[pos:o].zero_()
            flat[o:o + s].copy_(leaf.reshape(-1))
            pos = o + s
        if meta.padded > pos:
            flat[pos:].zero_()
        out.append(flat)
    return out


def group_buffers(leaves: Sequence[torch.Tensor], metas: Sequence[FlatMeta],
                  dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Working buffers a group: a direct group's leaf itself (no copy
    unless ``dtype`` casts it), a packed group's flat buffer."""
    out = []
    for meta in metas:
        if is_direct(meta):
            x = leaves[meta.leaf_indices[0]]
            out.append(x if dtype is None else x.to(dtype))
        else:
            out.extend(pack(leaves, [meta], dtype))
    return out


def _unpack_into(out: List, buf: torch.Tensor, meta: FlatMeta,
                 out_dtypes) -> None:
    for k, i in enumerate(meta.leaf_indices):
        o, s = meta.offsets[k], meta.sizes[k]
        piece = buf[o:o + s].reshape(meta.shapes[k])
        out[i] = piece if out_dtypes is None else piece.to(out_dtypes[i])


def assemble(group_bufs: Sequence[torch.Tensor], metas: Sequence[FlatMeta],
             out_dtypes: Optional[Sequence[torch.dtype]] = None
             ) -> List[torch.Tensor]:
    """The leaves from :func:`group_buffers`-shaped outputs: a direct
    group's buffer reshaped to its leaf, a packed one sliced (views where
    no cast is asked)."""
    out: List[Optional[torch.Tensor]] = [None] * metas[0].n_leaves
    for buf, meta in zip(group_bufs, metas):
        if is_direct(meta):
            i = meta.leaf_indices[0]
            piece = buf.reshape(meta.shapes[0])
            out[i] = piece if out_dtypes is None else piece.to(out_dtypes[i])
        else:
            _unpack_into(out, buf, meta, out_dtypes)
    return out


def unpack_groups(buffers: Sequence[torch.Tensor],
                  metas: Sequence[FlatMeta],
                  out_dtypes: Optional[Sequence[torch.dtype]] = None
                  ) -> List[torch.Tensor]:
    """The leaves from packed buffers (the inverse of :func:`pack`)."""
    out: List[Optional[torch.Tensor]] = [None] * metas[0].n_leaves
    for buf, meta in zip(buffers, metas):
        _unpack_into(out, buf, meta, out_dtypes)
    return out


def state_zeros(metas: Sequence[FlatMeta], device) -> Tuple[torch.Tensor,
                                                            ...]:
    """fp32 optimizer-state zeros a group: the leaf's shape for a direct
    group, the padded flat length for a packed one."""
    return tuple(
        torch.zeros(m.shapes[0] if is_direct(m) else (m.padded,),
                    dtype=torch.float32, device=device) for m in metas)


def per_tensor_sumsq(buf: torch.Tensor, meta: FlatMeta) -> torch.Tensor:
    """fp32 sum of squares of each tensor of a packed buffer, one entry a
    leaf: each slice runs to the next leaf's offset (the gap belongs to
    the tensor before it, so gaps must be zero, as :func:`pack` leaves
    them).  The per-tensor ``multi_tensor_l2norm`` role."""
    x = buf.float()
    ends = meta.offsets[1:] + (meta.padded,)
    return torch.stack([(x[o:e] * x[o:e]).sum()
                        for o, e in zip(meta.offsets, ends)])


def broadcast_per_tensor(values: torch.Tensor, meta: FlatMeta,
                         fill: float = 1.0) -> torch.Tensor:
    """``values[k]`` spread over tensor k's elements of a packed buffer,
    ``fill`` in the gaps and the padding (fp32)."""
    out = torch.full((meta.padded,), fill, dtype=torch.float32,
                     device=values.device)
    v = values.float()
    for k, (o, s) in enumerate(zip(meta.offsets, meta.sizes)):
        out[o:o + s] = v[k]
    return out
