"""Banded LaneConv aggregation: the `band_conv` CUDA kernels
(csrc/band_conv.cu, forward and backward) and their plain PyTorch versions.

    out[u] = Σ_j band_j[u] · feat[u + s_j] @ W_j     (rows outside [0, N) read 0)

Counterpart of lanegcn_tpu/ops/pallas_band_conv.py `band_conv`: the band
sum of the LaneConv layer's unfused branch (`ModelConfig(pallas_bands="off")`,
models/map_net.py), whose tail then runs as `fused_row_tail`. The public op
runs through a `torch.autograd.Function`: its backward is the
`band_conv_bwd` kernel on CUDA tensors and `band_conv_bwd_plain` on CPU
ones. As in the JAX op, the cotangent is rounded to feat's dtype first,
dW is summed in fp32 and cast to w's dtype, and the masks get no gradient.

The kernels, forward and backward, take rows W = 128 or 64 wide (`cuda.WIDTHS`:
the unfused LaneGCN at n_map = 128, and the half-width model at 64); the
plain versions take any width.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.lane_layer import HALO, _mask_bytes, _shift_array, _shift_rows


def band_conv_plain(feat, masks, w, shifts: Sequence[int]) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch: fp32 products of
    dtype-valued operands, the output cast once to feat's dtype."""
    f = feat.float()
    out = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    for j, s in enumerate(shifts):
        out = out + (_shift_rows(f, s) * masks[j].to(torch.float32)[:, None]) @ w[j].float()
    return out.to(feat.dtype)


def band_conv_bwd_plain(feat, masks, w, g, shifts: Sequence[int]):
    """The backward kernel's arithmetic, as the JAX op's `_bwd_impl`:

        g   rounded to feat's dtype
        dx[p] = Σ_j band_j[p − s_j] · g[p − s_j] @ W_jᵀ     (fp32, then feat's dtype)
        dW_j  = Σ_u (band_j[u] · feat[u + s_j])ᵀ g[u]        (fp32)

    Returns (dx, dW [J, W, W] fp32)."""
    f = feat.float()
    gr = g.to(feat.dtype).float()
    dx = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    dw = []
    for j, s in enumerate(shifts):
        m = masks[j].to(torch.float32)[:, None]
        dx = dx + _shift_rows(gr * m, -s) @ w[j].float().t()
        dw.append((_shift_rows(f, s) * m).t() @ gr)
    c = feat.shape[1]
    dw = torch.stack(dw) if dw else torch.zeros(0, c, c, dtype=torch.float32, device=feat.device)
    return dx.to(feat.dtype), dw


def _check(feat, masks, w, shifts, name="band_conv"):
    """Shapes and dtypes kernel `name` takes: feat [N, W] with W in
    `cuda.WIDTHS`, masks [J, N], w [J, W, W] in feat's dtype."""
    n, c = feat.shape
    j = len(shifts)
    cuda.check_width(name, c)
    if tuple(w.shape) != (j, c, c) or tuple(masks.shape) != (j, n):
        raise ValueError(f"{name}: bad shapes feat {tuple(feat.shape)} masks "
                         f"{tuple(masks.shape)} w {tuple(w.shape)} for {j} shifts")
    if any(abs(s) > HALO for s in shifts):
        raise ValueError(f"{name}: shifts beyond ±{HALO}: {shifts}")
    if w.dtype != feat.dtype:
        raise TypeError(f"{name}: w must be in feat's dtype")


def _fwd_cuda(feat, masks, w, shifts):
    """The `band_conv_fwd` kernel; the same output as `band_conv_plain`."""
    _check(feat, masks, w, shifts)
    masks = _mask_bytes(masks)
    # The bf16 kernel copies feat rows and the weights by 16-byte cp.async.
    feat, w = (cuda.param(t, t.dtype) for t in (feat, w))
    code = cuda.check_cuda("band_conv", feat, masks, w)
    out = torch.empty_like(feat)
    sh = _shift_array(shifts)
    cuda.call(
        "band_conv", "band_conv_fwd",
        cuda.ptr(feat), cuda.ptr(masks), cuda.ptr(w), cuda.ptr(out),
        ctypes.c_int(feat.shape[0]), ctypes.c_int(feat.shape[1]), ctypes.c_int(len(shifts)), sh,
        ctypes.c_int(code), cuda.stream(),
    )
    return out


def band_conv_bwd_cuda(feat, masks, w, g, shifts: Sequence[int]):
    """The `band_conv_bwd` kernel (a dx pass over g's halo tiles, then a
    (split, relation) dW pass with its partials summed in split order); the
    same outputs as `band_conv_bwd_plain`."""
    _check(feat, masks, w, shifts, "band_conv_bwd")
    if g.shape != feat.shape:
        raise ValueError(f"band_conv: g {tuple(g.shape)} is not feat's shape")
    g = g.to(feat.dtype).contiguous()
    masks = _mask_bytes(masks)
    w = cuda.param(w, w.dtype)
    code = cuda.check_cuda("band_conv", feat, masks, w, g)
    (n, c), j = feat.shape, len(shifts)
    splits = max(1, 2 * cuda.num_sms(feat.device) // max(j, 1))
    f32 = dict(dtype=torch.float32, device=feat.device)
    dx = torch.empty_like(feat)
    part = torch.empty(splits * j * c * c, **f32)
    dw = torch.empty(j, c, c, **f32)
    sh = _shift_array(shifts)
    cuda.call(
        "band_conv", "band_conv_bwd",
        cuda.ptr(feat), cuda.ptr(masks), cuda.ptr(w), cuda.ptr(g), cuda.ptr(dx), cuda.ptr(part),
        cuda.ptr(dw), ctypes.c_int(n), ctypes.c_int(c), ctypes.c_int(j), sh,
        ctypes.c_int(splits), ctypes.c_int(code), cuda.stream(),
    )
    return dx, dw


class _BandConv(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `band_conv_bwd_plain` / `band_conv_bwd_cuda`; dx in feat's
    dtype, dW cast to w's dtype, None for the masks."""

    @staticmethod
    def forward(ctx, feat, masks, w, shifts):
        ctx.save_for_backward(feat, masks, w)
        ctx.shifts = shifts
        if feat.device.type == "cpu":
            return band_conv_plain(feat, masks, w, shifts)
        return _fwd_cuda(feat, masks, w, shifts)

    @staticmethod
    def backward(ctx, g):
        feat, masks, w = ctx.saved_tensors
        bwd = band_conv_bwd_plain if feat.device.type == "cpu" else band_conv_bwd_cuda
        dx, dw = bwd(feat, masks, w, g, ctx.shifts)
        return dx, None, dw.to(w.dtype), None


def band_conv(feat, masks, w, shifts: Sequence[int]) -> torch.Tensor:
    """Σ_j masks[j] · (feat shifted by s_j) @ w[j] → [N, W] in feat's dtype.

    feat [N, W] (float32 or bfloat16; W = 128 or 64 on the card); masks
    [J, N] bool or 0/1 in feat's dtype; w [J, W, W] in (in, out) layout, in
    feat's dtype; shifts: J ints with |s| ≤ 32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"band_conv: unsupported device {feat.device}")
    return _BandConv.apply(feat.contiguous(), masks, w.contiguous(), tuple(shifts))


def work(feat, masks) -> dict:
    """Bytes the function must move and operations it does at these inputs,
    at feat's width W: feat read and out written once, the masks as they
    are given, the [W, W] weights once; one product (2·W² operations) per
    row each mask selects (the work depends on the masks' data)."""
    n, c = feat.shape
    j, db = masks.shape[0], feat.element_size()
    band_rows = int((masks != 0).sum())
    return {
        "bytes": 2 * n * c * db + masks.numel() * masks.element_size() + j * c * c * db,
        "flops": 2 * c * c * band_rows,
        "band_rows": band_rows,
    }


def work_bwd(feat, masks) -> dict:
    """The backward's, at feat's width W: feat and g read, dx written, the
    masks and the [W, W] weights read, dW written in fp32; two products (dx
    and dW, 2·W² operations each) per masked row."""
    n, c = feat.shape
    j, db = masks.shape[0], feat.element_size()
    band_rows = int((masks != 0).sum())
    return {
        "bytes": 3 * n * c * db + masks.numel() * masks.element_size() + j * c * c * (db + 4),
        "flops": 2 * 2 * c * c * band_rows,
        "band_rows": band_rows,
    }
