"""LanePooling's scatter of per-edge messages into a windowed node layout:
the `window_scatter` CUDA kernels (csrc/window_scatter.cu, forward and
backward) and their plain versions.

    out = temp;  out[wchunk[e // 512] * stride + lu[e]] += msg[e]  (lu[e] >= 0)

Counterpart of lanegcn_tpu/ops/pallas_window_scatter.py `window_scatter_add`
and its VJP. The edges come window-chunked (data/packing.py
`window_chunked_edges`): destination-sorted, each destination window's
edges filling whole WCHUNK-edge chunks, `wchunk` non-decreasing, lu = -1 on
padding. The sum is taken in fp32 and added to temp, then rounded once to
temp's dtype (the TPU kernel rounded after every chunk). Rows that no edge
reaches keep temp; the output is a new tensor. The TPU kernel's `first`
flags are not needed: with `wchunk` non-decreasing, the forward kernel is a
sorted segment sum (csrc/segment_sum.cuh) on a key derived from (wchunk,
lu), padding slots keyed between their window's rows and the next
window's.

The op runs through a `torch.autograd.Function`: its backward passes the
output cotangent g on to temp and gathers it for the messages,
d_msg[e] = g[dst[e]] (zeros on padding), in the `window_scatter_bwd`
kernel on CUDA tensors and `window_scatter_bwd_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.ops import cuda

# Edge chunk of the window-chunked layout (the packer aligns to it).
WCHUNK = 512


def flat_destinations(lu, wchunk, stride: int, n: int) -> torch.Tensor:
    """[E] int64 destination row of each edge, n on padding."""
    lu_f = lu.reshape(-1).long()
    base = wchunk.long().repeat_interleave(WCHUNK) * stride
    return torch.where(lu_f >= 0, base + lu_f, torch.full_like(lu_f, n))


def window_scatter_plain(msg, temp, lu, wchunk, stride: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, over every edge slot: the
    messages summed in fp32 in edge order (a padding slot, or a row past
    n, adds into a dropped row n), added to temp, one rounding to temp's
    dtype."""
    n, c = temp.shape
    dst = flat_destinations(lu, wchunk, stride, n).clamp(max=n)
    add = torch.zeros(n + 1, c, dtype=torch.float32, device=temp.device)
    add.index_add_(0, dst, msg.float())
    return (temp.float() + add[:n]).to(temp.dtype)


def window_scatter_bwd_plain(g, lu, wchunk, stride: int) -> torch.Tensor:
    """The backward kernel's function in PyTorch: d_msg [E, W] in g's
    dtype, g's row at each edge's destination, zeros on padding."""
    n = g.shape[0]
    dst = flat_destinations(lu, wchunk, stride, n)
    valid = (dst < n)[:, None]
    return torch.where(valid, g.index_select(0, dst.clamp(max=n - 1)),
                       torch.zeros((), dtype=g.dtype, device=g.device))


def _check(msg, temp, lu, wchunk, stride: int):
    e, c = msg.shape
    n = temp.shape[0]
    cuda.check_width("window_scatter", c)
    if (temp.shape[1] != c or e % WCHUNK or stride <= 0 or n % stride
            or tuple(lu.shape) != (e, 1) or tuple(wchunk.shape) != (e // WCHUNK,)):
        raise ValueError(f"window_scatter: bad shapes msg {msg.shape} temp {temp.shape} "
                         f"lu {lu.shape} wchunk {wchunk.shape} stride {stride}")
    if msg.dtype != temp.dtype:
        raise TypeError("window_scatter: msg and temp must share one dtype")
    if lu.dtype != torch.int32 or wchunk.dtype != torch.int32:
        raise TypeError("window_scatter: lu and wchunk must be int32")


def _fwd_cuda(msg, temp, lu, wchunk, stride: int):
    _check(msg, temp, lu, wchunk, stride)
    code = cuda.check_cuda("window_scatter", msg, temp, lu, wchunk)
    out = torch.empty_like(temp)
    cuda.call(
        "window_scatter", "window_scatter_fwd",
        cuda.ptr(msg), cuda.ptr(temp), cuda.ptr(lu), cuda.ptr(wchunk), cuda.ptr(out),
        ctypes.c_int(temp.shape[0] // stride), ctypes.c_int(stride),
        ctypes.c_int(wchunk.shape[0]), ctypes.c_int(msg.shape[1]), ctypes.c_int(code),
        cuda.stream(),
    )
    return out


def _check_bwd(g, lu, wchunk, stride: int):
    e, c = lu.shape[0], g.shape[1]
    cuda.check_width("window_scatter_bwd", c)
    if (e % WCHUNK or stride <= 0 or g.shape[0] % stride
            or tuple(lu.shape) != (e, 1) or tuple(wchunk.shape) != (e // WCHUNK,)):
        raise ValueError(f"window_scatter_bwd: bad shapes g {g.shape} lu {lu.shape} "
                         f"wchunk {wchunk.shape} stride {stride}")
    if lu.dtype != torch.int32 or wchunk.dtype != torch.int32:
        raise TypeError("window_scatter: lu and wchunk must be int32")


def window_scatter_bwd_cuda(g, lu, wchunk, stride: int) -> torch.Tensor:
    """The `window_scatter_bwd` kernel; the same output as
    `window_scatter_bwd_plain`."""
    _check_bwd(g, lu, wchunk, stride)
    e, c = lu.shape[0], g.shape[1]
    code = cuda.check_cuda("window_scatter", g, lu, wchunk)
    dmsg = torch.empty((e, c), dtype=g.dtype, device=g.device)
    cuda.call(
        "window_scatter", "window_scatter_bwd",
        cuda.ptr(g), cuda.ptr(lu), cuda.ptr(wchunk), cuda.ptr(dmsg), ctypes.c_int(stride),
        ctypes.c_int(wchunk.shape[0]), ctypes.c_int(c), ctypes.c_int(code), cuda.stream(),
    )
    return dmsg


class _WindowScatter(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: d_temp = g; d_msg from `window_scatter_bwd_plain` /
    `window_scatter_bwd_cuda`, in msg's dtype."""

    @staticmethod
    def forward(ctx, msg, temp, lu, wchunk, stride):
        fwd = window_scatter_plain if temp.device.type == "cpu" else _fwd_cuda
        out = fwd(msg, temp, lu, wchunk, stride)
        ctx.save_for_backward(lu, wchunk)  # after the launch, as row_tail's _RowTail2
        ctx.stride = stride
        return out

    @staticmethod
    def backward(ctx, g):
        lu, wchunk = ctx.saved_tensors
        g = g.contiguous()
        bwd = window_scatter_bwd_plain if g.device.type == "cpu" else window_scatter_bwd_cuda
        return bwd(g, lu, wchunk, ctx.stride), g, None, None, None


def window_scatter_add(msg, temp, lu, wchunk, stride: int) -> torch.Tensor:
    """temp + the window-chunked messages scattered into their rows.

    msg [E, W] and temp [N, W] in one dtype (N = windows x stride; W = 128
    or 64 on the card);
    lu [E, 1] and wchunk [E / 512] int32 as the packer emits them
    (EdgeSet.win_lu / win_chunk). CPU tensors take the plain versions; CUDA
    tensors launch the kernels. Gradients flow to msg and temp.
    """
    if temp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"window_scatter: unsupported device {temp.device}")
    return _WindowScatter.apply(msg.contiguous(), temp.contiguous(), lu.contiguous(),
                                wchunk.contiguous(), stride)


def work(msg, temp, lu, wchunk, stride: int) -> dict:
    """Bytes moved and operations done at these inputs: the messages of
    valid edges read once, temp read and the output written whole, lu and
    the chunk windows read; one add per valid edge and channel, and one per
    row for temp. Beside them, how the edges fall on the rows: the rows
    that take an edge and the longest run (a row's edges)."""
    e, c = msg.shape
    n = temp.shape[0]
    db = msg.element_size()
    dst = flat_destinations(lu, wchunk, stride, n)
    runs = torch.bincount(dst[dst < n], minlength=n)
    live = int(runs.sum())
    return {
        "bytes": live * c * db + 2 * n * c * db + e * 4 + (e // WCHUNK) * 4,
        "flops": (live + n) * c,
        "edges": e,
        "live_edges": live,
        "rows_with_edges": int((runs > 0).sum()),
        "longest_run": int(runs.max()) if n else 0,
    }


def work_bwd(g, lu, wchunk, stride: int) -> dict:
    """The backward's bytes at these inputs: each row of g that some valid
    edge points at read once, every d_msg row written, lu and the chunk
    windows read; no arithmetic (a row gather)."""
    e = lu.shape[0]
    n, c = g.shape
    db = g.element_size()
    dst = flat_destinations(lu, wchunk, stride, n)
    rows = int(torch.unique(dst[dst < n]).numel())
    return {"bytes": rows * c * db + e * c * db + e * 4 + (e // WCHUNK) * 4, "flops": 0,
            "edges": e, "live_edges": int((lu >= 0).sum()), "rows_read": rows}
