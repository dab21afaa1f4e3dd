"""Segment sum over destination-sorted edges: the `segment_sum` CUDA kernel
(csrc/segment_sum.cu) and its plain PyTorch version.

    out[s] = base[s] + Σ_{e : seg[e] = s} data[e]     seg non-decreasing; seg ≥ n dropped

Counterpart of lanegcn_tpu/ops/pallas_scatter.py `sorted_segment_sum` and
`scatter_add_sorted`. Each destination row's edges form one run, which the
kernel sums in edge order in fp32 (starting from `out`'s row when given)
and rounds once: no atomics, so a rerun is bitwise equal. The port's
`scatter_add` and its row gathers' backward (ops/scatter.py) run on it.
`scatter_add_sorted` carries the JAX VJP: the cotangent of data is a row
gather of the output's cotangent, zero on dropped edges; `out`'s is the
output's own.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lanegcn_tpu_torch.ops import cuda


def segment_sum_plain(data, seg, num_segments: int, out=None):
    """The kernel's arithmetic in PyTorch: each row starts from out's row
    (or 0) and adds its edges in edge order in fp32, then one rounding to
    data's dtype."""
    shape = (num_segments,) + tuple(data.shape[1:])
    rows = data.reshape(data.shape[0], math.prod(data.shape[1:])).float()
    acc = torch.zeros(num_segments + 1, rows.shape[1], dtype=torch.float32, device=data.device)
    if out is not None:
        acc[:num_segments] = out.reshape(num_segments, rows.shape[1]).float()
    acc.index_add_(0, seg.clamp(0, num_segments), rows)
    return acc[:num_segments].to(data.dtype).reshape(shape)


def _check(data, seg, num_segments, out):
    if seg.dim() != 1 or seg.shape[0] != data.shape[0]:
        raise ValueError(f"segment_sum: seg {tuple(seg.shape)} does not list data's "
                         f"{data.shape[0]} rows")
    if out is not None and (tuple(out.shape) != (num_segments,) + tuple(data.shape[1:])
                            or out.dtype != data.dtype):
        raise ValueError(f"segment_sum: out {tuple(out.shape)} {out.dtype} does not take "
                         f"data {tuple(data.shape)} {data.dtype} into {num_segments} rows")


def segment_sum_cuda(data, seg, num_segments: int, out=None):
    """The `segment_sum` kernel; the same output as `segment_sum_plain`."""
    _check(data, seg, num_segments, out)
    data, seg = data.contiguous(), seg.to(torch.int64).contiguous()
    out = None if out is None else out.contiguous()
    code = cuda.check_cuda("segment_sum", data, seg, out)
    dev = data.device
    res = torch.empty((num_segments,) + data.shape[1:], dtype=data.dtype, device=dev)
    cuda.call(
        "segment_sum", "segment_sum",
        cuda.ptr(data), cuda.ptr(seg), cuda.ptr(out), cuda.ptr(res),
        ctypes.c_longlong(data.shape[0]), ctypes.c_int(num_segments),
        ctypes.c_int(math.prod(data.shape[1:])),
        ctypes.c_int(code), cuda.stream(dev),
    )
    return res


def sorted_segment_sum(data, seg, num_segments: int, out=None):
    """out[s] (+)= Σ data[e] over the edges with seg[e] = s.

    data [E, ...] float32 or bfloat16; seg [E] int, non-decreasing, values
    ≥ num_segments dropped; out [num_segments, ...] in data's dtype or None.
    Returns a new tensor (out is not modified). CPU tensors take the plain
    version; CUDA tensors launch the kernel. No gradient: see
    `scatter_add_sorted`.
    """
    if data.device.type == "cpu":
        return segment_sum_plain(data, seg, num_segments, out)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {data.device}")
    return segment_sum_cuda(data, seg, num_segments, out)


class SegmentScatter(torch.autograd.Function):
    """out (+)= the segment sum of data's rows, listed by `perm` (None: in
    their order) with destinations `seg` (non-decreasing, ≥ n dropped).
    Backward: the cotangent's row at each data row's own destination `key`
    (zero where key ≥ n) for data, and the cotangent itself for out."""

    @staticmethod
    def forward(ctx, data, out, key, perm, seg, n):
        ctx.save_for_backward(key)
        ctx.n = n
        rows = data if perm is None else data.index_select(0, perm)
        return sorted_segment_sum(rows, seg, n, out)

    @staticmethod
    def backward(ctx, g):
        (key,) = ctx.saved_tensors
        d_data = None
        if ctx.needs_input_grad[0]:
            rows = g.index_select(0, key.clamp(0, ctx.n - 1))
            keep = (key < ctx.n).reshape((-1,) + (1,) * (rows.dim() - 1))
            d_data = torch.where(keep, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return d_data, (g if ctx.needs_input_grad[1] else None), None, None, None, None


def scatter_add_sorted(data, idx, num_segments: int, mask=None, out=None):
    """scatter_add for destination-sorted idx (non-decreasing over the
    valid edges, masked edges last): out[idx[e]] += data[e], masked edges
    dropped (their index is routed to num_segments). The forward is the
    segment-sum kernel, the backward a row gather."""
    seg = idx.reshape(-1).long()
    if mask is not None:
        seg = torch.where(mask.reshape(-1), seg, num_segments)
    if out is not None:
        data = data.to(out.dtype)
    return SegmentScatter.apply(data, out, seg, None, seg, num_segments)


def work(data, seg, num_segments: int, out=None) -> dict:
    """Bytes the function must move at these inputs: the kept edges' rows
    and their destinations read once, every output row written once (and
    out's rows read); no products. The dropped edges' rows need not be
    read."""
    db = data.element_size()
    cols = math.prod(data.shape[1:])
    kept = int((seg < num_segments).sum())
    rows = num_segments * (2 if out is not None else 1)
    return {"bytes": (kept + rows) * cols * db + kept * seg.element_size(), "flops": kept * cols,
            "edges": kept}
