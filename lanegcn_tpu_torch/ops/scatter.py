"""Masked gather / scatter-add over static-capacity edge lists.

Both run on the segment-sum kernel (ops/segment_sum.py): `scatter_add`'s
forward and `masked_gather`'s backward are sums of edge rows into their
destination rows. The edges are taken in destination order (`EdgeOrder`):
the pack's own order where it has one (destination-sorted lists, the
source-sorted inverse `inv_perm`/`inv_dst`, the tables' `table_inv`), else
one stable sort on the device, which a caller makes once and reuses across
layers. Masked edges are routed to the drop row num_segments, as the JAX
package's scatter routes them out of range: no compaction, so nothing waits
for the device, and no atomics, so the sums come out in one fixed order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from lanegcn_tpu_torch.ops import segment_sum


class EdgeOrder(NamedTuple):
    """Edge rows in destination order: `perm` lists rows of the per-edge
    tensor (None: its rows as they are) so that `seg`, the destination of
    each listed row (≥ the destination count where it is dropped), is
    non-decreasing."""

    perm: Optional[torch.Tensor]
    seg: torch.Tensor


def _keys(idx, mask, n: int) -> torch.Tensor:
    """Each edge's destination; n (dropped) where it is masked or out of
    range, as the JAX scatter's mode="drop"."""
    key = idx.reshape(-1)
    keep = (key >= 0) & (key < n)
    if mask is not None:
        keep &= mask.reshape(-1)
    return torch.where(keep, key, n)


def _sorted(key: torch.Tensor) -> EdgeOrder:
    seg, perm = torch.sort(key, stable=True)
    return EdgeOrder(perm, seg)


def order_by(idx, mask, n: int) -> EdgeOrder:
    """One stable sort of the edges by destination, masked edges last."""
    return _sorted(_keys(idx, mask, n))


def dst_order(edges, n: int) -> EdgeOrder | None:
    """The destination order an EdgeSet carries (a destination-sorted list,
    padding last), or None."""
    if not edges.dst_sorted:
        return None
    return EdgeOrder(None, _keys(edges.u, edges.mask, n))


def src_order(edges, n: int) -> EdgeOrder | None:
    """The source order an EdgeSet carries (its inverse: inv_perm, and
    inv_dst with n on padding), or None."""
    if edges.inv_perm is None:
        return None
    return EdgeOrder(edges.inv_perm, edges.inv_dst)


def table_order(table_inv, num_tables: int, n: int) -> EdgeOrder:
    """The stacked neighbour tables' source order from the pack's table_inv
    (u: the flat row tabled_relation * n + u of the stacked gather, v: its
    source row, sorted by v)."""
    perm = table_inv.u.clamp(0, num_tables * n - 1)
    return EdgeOrder(perm, torch.where(table_inv.mask, table_inv.v, n))


class _MaskedGather(torch.autograd.Function):
    """x[idx] with masked rows zeroed; backward: the segment sum of the
    cotangent's rows into their source rows, in `order` (made from idx and
    mask when the caller gave none)."""

    @staticmethod
    def forward(ctx, x, idx, mask, order):
        out = _gather(x, idx, mask)
        ctx.save_for_backward(idx, mask)
        ctx.order, ctx.n = order, x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, mask = ctx.saved_tensors
        order = ctx.order
        if order is None:  # the forward gathered clamped rows: their cotangent goes there
            order = order_by(idx.clamp(0, ctx.n - 1), mask, ctx.n)
        rows = g.reshape((idx.numel(),) + g.shape[idx.dim():])
        if order.perm is not None:
            rows = rows.index_select(0, order.perm)
        return segment_sum.sorted_segment_sum(rows, order.seg, ctx.n), None, None, None


def _gather(x, idx, mask):
    out = x.index_select(0, idx.reshape(-1).clamp(0, x.shape[0] - 1))
    out = out.reshape(idx.shape + x.shape[1:])
    if mask is not None:
        out = torch.where(mask.reshape(mask.shape + (1,) * (out.dim() - mask.dim())), out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def masked_gather(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor | None = None,
                  order: EdgeOrder | None = None) -> torch.Tensor:
    """Rows x[idx], indices clamped into range; rows where mask is False are
    zeroed (so clamping never leaks data). Returns idx.shape + x.shape[1:].

    The gather is an index_select; its backward sums the cotangent's rows
    into x's rows with the segment-sum kernel, in `order` (the source order
    of idx's flat entries: `src_order`, `table_order`, or one `order_by`
    shared by several gathers), or in one sort made in the backward.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        return _MaskedGather.apply(x, idx, mask, order)
    return _gather(x, idx, mask)


def scatter_add(
    data: torch.Tensor,
    idx: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    order: EdgeOrder | None = None,
) -> torch.Tensor:
    """out[idx[e]] += data[e] for valid edges; masked edges are dropped.

    Returns a new tensor (out is not modified) in out's dtype (data's
    without out). `order`: the edges' destination order (`dst_order`,
    `src_order` for a scatter by source, or one `order_by` shared by
    several scatters); without it one stable sort is made here. The sum
    runs in the segment-sum kernel, each row's edges in that order in fp32,
    so the result is the same on every run.
    """
    if out is not None:
        data = data.to(out.dtype)
    key = _keys(idx, mask, num_segments)
    if order is None:
        order = _sorted(key)
    if data.shape[0] != key.shape[0]:
        raise ValueError(f"scatter_add: {data.shape[0]} rows for {key.shape[0]} indices")
    rows = data.reshape((key.shape[0], math.prod(data.shape[1:])))
    base = None if out is None else out.reshape(num_segments, -1)
    res = segment_sum.SegmentScatter.apply(rows, base, key, order.perm, order.seg, num_segments)
    return res.reshape((num_segments,) + tuple(data.shape[1:]))


def segment_softmax(
    logits: torch.Tensor,
    idx: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Numerically stable softmax over edges grouped by destination segment
    (lanegcn_tpu/ops/scatter.py segment_softmax; LaneGCN's Att sums, so no
    model of the port calls it). logits: [E]; returns [E].

    The segment max is a scatter_reduce("amax") from finfo.min, masked
    edges routed to a drop row (the maximum takes no order, so it is the
    same on every run); the shift reads it at clamped indices; masked edges
    get exp 0; the denominator is `scatter_add`, the segment-sum kernel on
    the card, divided with a floor of finfo.tiny."""
    n = num_segments
    key = _keys(idx, mask, n)
    fi = torch.finfo(logits.dtype)
    seg_max = torch.full((n + 1,), fi.min, dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(0, key, logits.reshape(-1), "amax")[:n]
    at = idx.clamp(0, n - 1)
    ex = torch.exp(logits - seg_max[at])
    if mask is not None:
        ex = torch.where(mask, ex, torch.zeros((), dtype=ex.dtype, device=ex.device))
    denom = scatter_add(ex, idx, n, mask=mask)[at]
    return ex / denom.clamp_min(fi.tiny)
