"""LanePooling's scatter of per-edge messages into a windowed node layout:
the `window_scatter` CUDA kernel (csrc/window_scatter.cu, forward) and its
plain version.

    out = temp;  out[wchunk[e // 512] * stride + lu[e]] += msg[e]  (lu[e] >= 0)

Counterpart of lanegcn_tpu/ops/pallas_window_scatter.py `window_scatter_add`
(its forward). The edges come window-chunked (data/packing.py
`window_chunked_edges`): destination-sorted, each destination window's
edges filling whole WCHUNK-edge chunks, `wchunk` non-decreasing, lu = -1 on
padding. The sum is taken in fp32 and added to temp, then rounded once to
temp's dtype (the TPU kernel rounded after every chunk). Rows that no edge
reaches keep temp; the output is a new tensor. The TPU kernel's `first`
flags are not needed: with `wchunk` non-decreasing, a window's chunks are
found by binary search.

Forward only: LaneRCNN's training path (this op's backward,
d_msg[e] = g[dst[e]]) is not ported yet, so a CUDA call that would need a
gradient raises.
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
    """The kernel's arithmetic in PyTorch: the messages summed in fp32 in
    edge order, added to temp, one rounding to temp's dtype."""
    n, c = temp.shape
    dst = flat_destinations(lu, wchunk, stride, n)
    keep = (dst < n).nonzero().squeeze(1)
    add = torch.zeros(n, c, dtype=torch.float32, device=temp.device)
    add.index_add_(0, dst[keep], msg[keep].float())
    return (temp.float() + add).to(temp.dtype)


def _check(msg, temp, lu, wchunk, stride: int):
    e, c = msg.shape
    n = temp.shape[0]
    if (c != 128 or temp.shape[1] != c or e % WCHUNK or stride <= 0 or n % stride
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
        ctypes.c_int(wchunk.shape[0]), ctypes.c_int(code), cuda.stream(),
    )
    return out


def window_scatter_add(msg, temp, lu, wchunk, stride: int) -> torch.Tensor:
    """temp + the window-chunked messages scattered into their rows.

    msg [E, 128] and temp [N, 128] in one dtype (N = windows x stride);
    lu [E, 1] and wchunk [E / 512] int32 as the packer emits them
    (EdgeSet.win_lu / win_chunk). CPU tensors take the plain version; CUDA
    tensors launch the kernel.
    """
    if temp.device.type == "cpu":
        return window_scatter_plain(msg, temp, lu, wchunk, stride)
    if temp.device.type != "cuda":
        raise ValueError(f"window_scatter: unsupported device {temp.device}")
    cuda.check_no_grad("window_scatter", msg, temp)
    return _fwd_cuda(msg.contiguous(), temp.contiguous(), lu.contiguous(),
                     wchunk.contiguous(), stride)


def work(msg, temp, lu) -> dict:
    """Bytes moved and operations done at these inputs: the messages of
    valid edges read once, temp read and the output written whole, lu and
    the chunk windows read; one add per valid edge and channel, and one per
    row for temp."""
    e, c = msg.shape
    n = temp.shape[0]
    db = msg.element_size()
    live = int((lu >= 0).sum())
    return {
        "bytes": live * c * db + 2 * n * c * db + e * 4 + (e // WCHUNK) * 4,
        "flops": (live + n) * c,
        "edges": e,
        "live_edges": live,
    }
