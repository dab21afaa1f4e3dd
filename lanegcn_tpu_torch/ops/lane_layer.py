"""Fused LaneConv residual layer: the `lane_layer` CUDA kernels
(csrc/lane_layer.cu, forward and backward) and their plain PyTorch versions.

    temp = pre + Σ_j band_j ⊙ feat[u + s_j] @ Wb_j     (rows outside [0, N) read 0)
    out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)

Counterpart of lanegcn_tpu/ops/pallas_lane_layer.py `fused_lane_layer`.
When a gradient is wanted the public op runs through a
`torch.autograd.Function`: its forward also keeps temp (fp32; on the card
the forward kernel writes it, bitwise its own value) and its backward is the
`lane_layer_bwd` kernel on CUDA tensors, `lane_layer_bwd_plain` on CPU ones.

`fused_lane_layer_plan` (the `lane_plan` kernels, csrc/lane_plan.cu) is the
same layer with the window plan's aggregate added into temp inside it, the
counterpart of `fused_lane_layer_plan` there; see its section below.

The layer's kernels and `lane_plan`'s, forward and backward, take rows
W = 128 or 64 wide (`cuda.WIDTHS`: LaneGCN at n_map = 128, and the
half-width model at 64); the layer's also take 256 both ways (the
double-width model, csrc/wide.cuh and csrc/wide_bwd.cuh). The plain
versions take any width.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import group_norm
from lanegcn_tpu_torch.ops.row_tail import part_size, tail_bwd_plain, wide_part_floats
from lanegcn_tpu_torch.ops.scenario_agg import (
    _CHUNK as _PLAN_CHUNK, _blocks, _per_relation, _prep_for, plan_edge_count, plan_edges)

HALO = 32


def _shift_rows(x: torch.Tensor, s: int) -> torch.Tensor:
    """rows[u] = x[u + s], zero where u + s falls outside [0, N)."""
    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, HALO, HALO))
    return xp[HALO + s : HALO + s + n]


def _temp_plain(feat, pre, masks, wb, shifts):
    """pre + the band products, fp32 (the kernel's temp)."""
    f = feat.float()
    temp = pre.float()
    for j, s in enumerate(shifts):
        rows = _shift_rows(f, s) * masks[j].to(torch.float32)[:, None]
        temp = temp + rows @ wb[j].float()
    return temp


def _tail_plain(feat, temp, w2, g1w, g1b, g2w, g2b, eps):
    dt = feat.dtype
    h = torch.relu(group_norm(temp, g1w, g1b, 1, eps)).to(dt).float()
    z = h @ w2.float()
    y = group_norm(z, g2w, g2b, 1, eps)
    return torch.relu(y + feat.float()).to(dt)


def lane_layer_plain(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b,
                     shifts: Sequence[int], eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 products of dtype-valued
    operands; h rounded to the activation dtype before the second product."""
    temp = _temp_plain(feat, pre, masks, wb, shifts)
    return _tail_plain(feat, temp, w2, g1w, g1b, g2w, g2b, eps)


def _band_bwd_plain(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, g, shifts, eps):
    """lane_layer_bwd_plain before its roundings: fp32 d_temp and dx, then
    dWb, dW2 and the four GN vector gradients."""
    d_temp, d_y, dw2, *dgn = tail_bwd_plain(temp, feat, w2, g1w, g1b, g2w, g2b, g, eps)
    f = feat.float()
    dt_r = d_temp.to(feat.dtype).float()
    dx = d_y
    dwb = []
    for j, s in enumerate(shifts):
        m = masks[j].to(torch.float32)[:, None]
        dx = dx + _shift_rows(d_temp * m, -s) @ wb[j].float().t()
        dwb.append((_shift_rows(f, s) * m).t() @ dt_r)
    c = feat.shape[1]
    dwb = torch.stack(dwb) if dwb else torch.zeros(0, c, c, dtype=torch.float32,
                                                   device=feat.device)
    return d_temp, dx, dwb, dw2, dgn


def lane_layer_bwd_plain(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, g,
                         shifts: Sequence[int], eps: float = 1e-5):
    """The backward kernel's arithmetic, from the forward's fp32 temp:

        d_y, d_temp = the tail's backward (row_tail.tail_bwd_plain)
        dx  = d_y + Σ_j band_j[p − s_j] · d_temp[p − s_j] @ Wb_jᵀ   (fp32 d_temp)
        dWb_j = Σ_u (band_j[u] · feat[u + s_j])ᵀ rnd(d_temp[u])

    Returns (dx, dpre) in feat's dtype, then fp32 dWb [J, W, W], dW2 and
    the four GN vector gradients.
    """
    dt = feat.dtype
    d_temp, dx, dwb, dw2, dgn = _band_bwd_plain(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b,
                                                g, shifts, eps)
    return (dx.to(dt), d_temp.to(dt), dwb, dw2, *dgn)


def _check(feat, pre, masks, wb, w2, gns, shifts, name="lane_layer"):
    """Shapes and dtypes kernel `name` takes: feat/pre [N, W] with W in
    `cuda.WIDTHS` for `name`, wb [J, W, W], w2 [W, W], masks [J, N], the GN
    vectors [W]."""
    n, c = feat.shape
    j = len(shifts)
    cuda.check_width(name, c)
    if (pre.shape != feat.shape or tuple(wb.shape) != (j, c, c)
            or tuple(w2.shape) != (c, c) or tuple(masks.shape) != (j, n)
            or any(tuple(g.shape) != (c,) for g in gns)):
        raise ValueError(f"{name}: bad shapes feat {feat.shape} pre {pre.shape} "
                         f"masks {masks.shape} wb {wb.shape} w2 {w2.shape}")
    if any(abs(s) > HALO for s in shifts):
        raise ValueError(f"{name}: shifts beyond ±{HALO}: {shifts}")
    if pre.dtype != feat.dtype or wb.dtype != feat.dtype or w2.dtype != feat.dtype:
        raise TypeError(f"{name}: feat, pre, wb and w2 must share one dtype")


def _mask_bytes(masks):
    if masks.dtype == torch.bool:
        return masks.contiguous().view(torch.uint8)
    if masks.dtype != torch.uint8:
        return (masks != 0).to(torch.uint8)
    return masks.contiguous()


_SHIFT_ARRAYS = {}  # shift tuple: (its C int array, the array's address)


def _shift_array(shifts):
    """The address of the shifts as a C int array, made once per shift list
    (the layer passes the same list at every launch)."""
    key = tuple(shifts)
    if key not in _SHIFT_ARRAYS:
        arr = (ctypes.c_int * max(len(key), 1))(*key)
        _SHIFT_ARRAYS[key] = (arr, ctypes.cast(arr, ctypes.c_void_p))
    return _SHIFT_ARRAYS[key][1]


def _gn_params(*gns):
    """The GroupNorm vectors as the layer kernels read them: fp32 and
    contiguous. The kernels read them element by element, so a vector 4
    bytes off a 16-byte boundary (the flat optimizer's views) is not copied."""
    return [cuda.param(t, align=4) for t in gns]


def _fwd_cuda(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, shifts, eps, save_temp=False):
    """The forward kernel; returns out, or (out, temp fp32) with save_temp."""
    _check(feat, pre, masks, wb, w2, (g1w, g1b, g2w, g2b), shifts)
    n, c = feat.shape
    masks = _mask_bytes(masks)
    gns = _gn_params(g1w, g1b, g2w, g2b)
    # The bf16 kernel copies feat rows and the weights by 16-byte cp.async.
    feat, wb, w2 = (cuda.param(t, t.dtype) for t in (feat, wb, w2))
    code = cuda.check_cuda("lane_layer", feat, pre, masks, wb, w2, *gns)
    out = torch.empty_like(feat)
    temp = torch.empty(n, c, dtype=torch.float32, device=feat.device) if save_temp else None
    sh = _shift_array(shifts)
    cuda.call(
        "lane_layer", "lane_layer_fwd",
        cuda.ptr(feat), cuda.ptr(pre), cuda.ptr(masks), cuda.ptr(wb), cuda.ptr(w2),
        *(cuda.ptr(g) for g in gns), cuda.ptr(out), cuda.ptr(temp),
        ctypes.c_int(n), ctypes.c_int(c), ctypes.c_int(len(shifts)), sh,
        ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return (out, temp) if save_temp else out


def lane_layer_bwd_cuda(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, g,
                        shifts: Sequence[int], eps: float = 1e-5):
    """The `lane_layer_bwd` kernel; the same outputs as `lane_layer_bwd_plain`."""
    _check(feat, feat, masks, wb, w2, (g1w, g1b, g2w, g2b), shifts, "lane_layer_bwd")
    n, c = feat.shape
    j = len(shifts)
    if (temp.shape != feat.shape or temp.dtype != torch.float32
            or g.shape != feat.shape or g.dtype != feat.dtype):
        raise ValueError(f"lane_layer: temp must be fp32 and g in feat's dtype, both [N, {c}]")
    masks = _mask_bytes(masks)
    gns = _gn_params(g1w, g1b, g2w, g2b)
    code = cuda.check_cuda("lane_layer", feat, temp, masks, wb, w2, g, *gns)
    dev = feat.device
    tail_blocks = cuda.num_sms(dev)
    # dWb's blocks: one relation each at 128 and 64, one quadrant of one at 256.
    splits = max(1, 2 * tail_blocks // (max(j, 1) * (4 if c == 256 else 1)))
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dpre = torch.empty_like(feat), torch.empty_like(feat)
    # The workspaces (d_temp, d_y and both passes' partials, all W wide; at
    # 256 also the row pass's dW operands) in one allocation, passed by
    # address; the outputs in their own, so that a gradient kept after the
    # call holds no workspace.
    part = part_size(c)
    tail = (-(-wide_part_floats(n, tail_blocks, feat.element_size()) // (4 * tail_blocks)) * 4
            if c == 256 else part)  # whole float4s a block: part_band stays 16-byte aligned
    work = torch.empty(2 * n * c + tail_blocks * tail + splits * j * c * c, **f32)
    at = work.data_ptr()
    ws = [ctypes.c_void_p(at + 4 * off) for off in
          (0, n * c, 2 * n * c, 2 * n * c + tail_blocks * tail)]
    grads = torch.empty(part + j * c * c, **f32)
    dw2, dgn, dwb = grads.split([c * c, 4 * c, j * c * c])
    cuda.call(
        "lane_layer", "lane_layer_bwd",
        cuda.ptr(feat), cuda.ptr(temp), cuda.ptr(masks), cuda.ptr(wb), cuda.ptr(w2),
        *(cuda.ptr(t) for t in gns), cuda.ptr(g), cuda.ptr(dx), cuda.ptr(dpre), *ws,
        cuda.ptr(grads), cuda.ptr(dwb), ctypes.c_int(n), ctypes.c_int(c), ctypes.c_int(j),
        _shift_array(shifts), ctypes.c_int(tail_blocks), ctypes.c_int(splits),
        ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return (dx, dpre, dwb.view(j, c, c), dw2.view(c, c), *dgn.view(4, c).unbind(0))


class _LaneLayer(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel (with temp) on
    CUDA tensors. Backward: `lane_layer_bwd_plain` / `lane_layer_bwd_cuda`;
    each cotangent comes back in its primal's dtype; the masks get None."""

    @staticmethod
    def forward(ctx, feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, shifts, eps):
        if feat.device.type == "cpu":
            temp = _temp_plain(feat, pre, masks, wb, shifts)
            out = _tail_plain(feat, temp, w2, g1w, g1b, g2w, g2b, eps)
        else:
            out, temp = _fwd_cuda(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, shifts, eps,
                                  save_temp=True)
        ctx.save_for_backward(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b)
        ctx.shifts, ctx.eps, ctx.pre_dtype = tuple(shifts), eps, pre.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b = ctx.saved_tensors
        bwd = lane_layer_bwd_plain if feat.device.type == "cpu" else lane_layer_bwd_cuda
        dx, dpre, dwb, dw2, *dgn = bwd(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b,
                                       g.to(feat.dtype).contiguous(), ctx.shifts, ctx.eps)
        return (dx, dpre.to(ctx.pre_dtype), None, dwb.to(wb.dtype), dw2.to(w2.dtype),
                *(d.to(p.dtype) for d, p in zip(dgn, (g1w, g1b, g2w, g2b))), None, None)


def fused_lane_layer(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b,
                     shifts: Sequence[int], eps: float = 1e-5) -> torch.Tensor:
    """relu(GN2(relu(GN1(pre + band_conv(feat))) @ w2) + feat).

    feat/pre [N, W] (float32 or bfloat16; W = 128, 64 or 256 on the card);
    masks [J, N] bool or 0/1; wb [J, W, W] and w2 [W, W] in (in, out)
    layout, in feat's dtype; GN affines [W] fp32; shifts: J ints with |s| ≤
    32. CPU tensors take the plain version; CUDA tensors launch the kernel
    (forward and backward).
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_layer: unsupported device {feat.device}")
    args = (feat.contiguous(), pre.contiguous(), masks, wb.contiguous(), w2.contiguous(),
            g1w, g1b, g2w, g2b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _LaneLayer.apply(*args, tuple(shifts), eps)
    if feat.device.type == "cpu":
        return lane_layer_plain(*args, shifts, eps)
    return _fwd_cuda(*args, shifts, eps)


def work(feat, masks) -> dict:
    """Bytes the function must move and operations it does at these inputs,
    at feat's width W: feat, pre and out whole (W wide), the masks as
    bytes, the [W, W] weights once; a band product (2·W² operations a row)
    only on the rows its mask selects (the work depends on the masks'
    data), the second product on every row."""
    n, c = feat.shape
    j, db = masks.shape[0], feat.element_size()
    band_rows = int((masks != 0).sum())
    return {
        "bytes": 3 * n * c * db + j * n + (j + 1) * c * c * db + 4 * c * 4,
        "flops": 2 * c * c * (band_rows + n),
        "band_rows": band_rows,
    }


def work_bwd(feat, masks) -> dict:
    """The backward's bytes and operations at these inputs, at feat's width
    W: feat, g and the fp32 temp read, dx and dpre written (W wide), the
    masks, the [W, W] weights read and their gradients written; the band
    transpose and dWb (2·W² operations a row each) only on the rows each
    mask selects, and three [N, W] x [W, W] products (z recomputed, d_h,
    dW2) on every row."""
    n, c = feat.shape
    j, db = masks.shape[0], feat.element_size()
    band_rows = int((masks != 0).sum())
    return {
        "bytes": 4 * n * c * db + n * c * 4 + j * n + (j + 1) * c * c * (db + 4) + 8 * c * 4,
        "flops": 2 * 2 * c * c * band_rows + 3 * 2 * c * c * n,
        "band_rows": band_rows,
    }


# ---------------------------------------------------------------------------
# The layer with the window plan's aggregate inside it: `lane_plan`
# (csrc/lane_plan.cu, forward and backward), counterpart of
# pallas_lane_layer.py `fused_lane_layer_plan`.
#
#     temp = pre + band_conv(feat) + Σ_{applied slots (u ← v, r)} rnd(feat[v] @ W_r)
#     out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)
#
# Node rows are num_win windows of t = N / num_win rows (t % 128 == 0); the
# plan is [num_win * ECAP, 1] int32 lu/lv/rel (ECAP % 512 == 0), window-local,
# with the chunk-aligned relation groups of `scenario_agg`. Each plan
# message is rounded to the activation dtype before its fp32 sum, as the TPU
# kernel rounds it. The backward:
#
#     d_msg = rnd(d_temp[u]);  dfeat[v] += rnd(d_msg @ W_rᵀ);  dW_r += rnd(feat[v])ᵀ d_msg
#
# in fp32, on top of lane_layer's backward. The TPU kernel rounds dfeat to the
# activation dtype after every 512-slot chunk; the port sums it in fp32 and
# rounds once, as scenario_agg does.
#
# On the card the kernels take the plan as `scenario_agg.prepare_plan`
# prepares it (a `PlanPrep`, which a LaneConv stack makes once per call and
# hands to every layer and its backward; the wrappers make one when given
# none): the rounded messages go to a [slots, W] workspace in the
# activation dtype at their destination (source) positions, and the layer
# adds each row's run of positions in order (csrc/lane_plan.cu).


def _plan_check(feat, w_rel, lu, lv, rel, num_win):
    n, c = feat.shape
    r_num = w_rel.shape[0]
    if (num_win <= 0 or n % num_win or (n // num_win) % 128 or lu.shape[0] % num_win
            or (lu.shape[0] // num_win) % _PLAN_CHUNK or tuple(w_rel.shape) != (r_num, c, c)
            or lv.shape != lu.shape or rel.shape != lu.shape or lu.numel() != lu.shape[0]):
        raise ValueError(f"lane_plan: bad shapes feat {tuple(feat.shape)} w_rel "
                         f"{tuple(w_rel.shape)} plan {tuple(lu.shape)} windows {num_win}: the "
                         f"window stride must be a multiple of 128 and the plan's slots per "
                         f"window of {_PLAN_CHUNK}")
    if w_rel.dtype != feat.dtype:
        raise TypeError("lane_plan: w_rel must be in feat's dtype")
    for t in (lu, lv, rel):
        if t.dtype != torch.int32:
            raise TypeError("lane_plan: plan indices must be int32")


def _plan_rows(feat, w_rel, lu, lv, rel, num_win, groups):
    """The applied plan edges: flat (u, v) rows by relation, and the counts."""
    u, v, counts = plan_edges(lu, lv, rel, num_win, feat.shape[0] // num_win, groups,
                              w_rel.shape[0])
    k = sum(counts)
    return u[:k], v[:k], counts


def _plan_temp_plain(feat, pre, masks, wb, shifts, w_rel, lu, lv, rel, num_win, groups):
    """pre + the band products + the rounded plan messages, fp32."""
    temp = _temp_plain(feat, pre, masks, wb, shifts)
    u, v, counts = _plan_rows(feat, w_rel, lu, lv, rel, num_win, groups)
    msg = _per_relation(feat[v].float(), w_rel, counts).to(feat.dtype).float()
    return temp.index_add(0, u, msg)


def lane_plan_plain(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel,
                    num_win: int, shifts: Sequence[int], groups=None,
                    eps: float = 1e-5) -> torch.Tensor:
    """The forward kernel's arithmetic in PyTorch (lane_layer_plain with the
    rounded plan messages added into temp)."""
    temp = _plan_temp_plain(feat, pre, masks, wb, shifts, w_rel, lu, lv, rel, num_win, groups)
    return _tail_plain(feat, temp, w2, g1w, g1b, g2w, g2b, eps)


def lane_plan_bwd_plain(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel,
                        num_win: int, groups, g, shifts: Sequence[int], eps: float = 1e-5):
    """The backward kernel's arithmetic, from the forward's fp32 temp:
    lane_layer_bwd_plain's, plus the plan's transpose into dx (fp32, one
    rounding) and dW_rel. Returns (dx, dpre) in feat's dtype, then fp32 dWb,
    dW2, the four GN vector gradients and dW_rel [R, W, W]."""
    dt = feat.dtype
    d_temp, dx, dwb, dw2, dgn = _band_bwd_plain(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b,
                                                g, shifts, eps)
    u, v, counts = _plan_rows(feat, w_rel, lu, lv, rel, num_win, groups)
    d_msg = d_temp[u].to(dt).float()
    d_gath = _per_relation(d_msg, w_rel, counts, transpose=True).to(dt).float()
    dx = dx.index_add(0, v, d_gath)
    gath = feat[v].float()
    dwr = torch.zeros(w_rel.shape, dtype=torch.float32, device=feat.device)
    o = 0
    for r, cnt in enumerate(counts):
        dwr[r] = gath[o:o + cnt].t() @ d_msg[o:o + cnt]
        o += cnt
    return (dx.to(dt), d_temp.to(dt), dwb, dw2, *dgn, dwr)


def _plan_fwd_cuda(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel, num_win,
                   shifts, groups, eps, prep=None, save_temp=False):
    """The forward kernel on the prepared plan (`prep`, or one prepared
    here); returns out, or (out, temp fp32) with save_temp."""
    _check(feat, pre, masks, wb, w2, (g1w, g1b, g2w, g2b), shifts, "lane_plan")
    _plan_check(feat, w_rel, lu, lv, rel, num_win)
    (n, c), r_num, slots = feat.shape, w_rel.shape[0], lu.shape[0]
    prep = _prep_for(lu, lv, rel, num_win, n, groups, r_num, prep, False)
    masks = _mask_bytes(masks)
    gns = _gn_params(g1w, g1b, g2w, g2b)
    # The bf16 kernels copy feat rows and the weights by 16-byte cp.async.
    feat, wb, w2, w_rel = (cuda.param(t, t.dtype) for t in (feat, wb, w2, w_rel))
    code = cuda.check_cuda("lane_plan", feat, pre, masks, wb, w2, w_rel, *gns, *prep[:7])
    ws = torch.empty(slots, c, dtype=feat.dtype, device=feat.device)
    out = torch.empty_like(feat)
    temp = torch.empty(n, c, dtype=torch.float32, device=feat.device) if save_temp else None
    cuda.call(
        "lane_plan", "lane_plan_fwd",
        cuda.ptr(feat), cuda.ptr(pre), cuda.ptr(masks), cuda.ptr(wb), cuda.ptr(w2),
        *(cuda.ptr(t) for t in gns), cuda.ptr(w_rel), cuda.ptr(prep.src), cuda.ptr(prep.tiles),
        cuda.ptr(prep.rel_tiles), cuda.ptr(prep.dpos), cuda.ptr(prep.dseg), cuda.ptr(ws),
        cuda.ptr(out), cuda.ptr(temp), ctypes.c_int(n), ctypes.c_int(c), ctypes.c_int(len(shifts)),
        _shift_array(shifts), ctypes.c_longlong(slots), ctypes.c_int(r_num),
        ctypes.c_int(_blocks(feat.device)), ctypes.c_float(eps), ctypes.c_int(code),
        cuda.stream(),
    )
    return (out, temp) if save_temp else out


def lane_plan_bwd_cuda(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel,
                       num_win: int, groups, g, shifts: Sequence[int], eps: float = 1e-5,
                       prep=None):
    """The `lane_plan_bwd` kernel on the prepared plan (`prep` with its
    source order, or one prepared here); the same outputs as
    `lane_plan_bwd_plain`."""
    _check(feat, feat, masks, wb, w2, (g1w, g1b, g2w, g2b), shifts, "lane_plan_bwd")
    _plan_check(feat, w_rel, lu, lv, rel, num_win)
    (n, c), slots = feat.shape, lu.shape[0]
    j, r_num = len(shifts), w_rel.shape[0]
    if (temp.shape != feat.shape or temp.dtype != torch.float32
            or g.shape != feat.shape or g.dtype != feat.dtype):
        raise ValueError(f"lane_plan: temp must be fp32 and g in feat's dtype, both [N, {c}]")
    prep = _prep_for(lu, lv, rel, num_win, n, groups, r_num, prep, True)
    masks = _mask_bytes(masks)
    gns = _gn_params(g1w, g1b, g2w, g2b)
    feat, wb, w2, w_rel = (cuda.param(t, t.dtype) for t in (feat, wb, w2, w_rel))
    code = cuda.check_cuda("lane_plan", feat, temp, masks, wb, w2, w_rel, g, *gns, *prep[:9])
    dev = feat.device
    tail_blocks, blocks = cuda.num_sms(dev), _blocks(dev)
    splits = max(1, 2 * tail_blocks // max(j, 1))
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dpre = torch.empty_like(feat), torch.empty_like(feat)
    ws = torch.empty(slots, c, dtype=feat.dtype, device=dev)
    # The fp32 workspaces (d_temp, d_y and the passes' partials, all W
    # wide) in one allocation, passed by address; the outputs in their own,
    # so that a gradient kept after the call holds no workspace.
    part = part_size(c)
    sizes = (n * c, n * c, tail_blocks * part, splits * j * c * c, (blocks + r_num) * c * c)
    work = torch.empty(sum(sizes), **f32)
    offs = [sum(sizes[:i]) for i in range(len(sizes))]
    parts = [ctypes.c_void_p(work.data_ptr() + 4 * o) for o in offs]
    grads = torch.empty(part + (j + r_num) * c * c, **f32)
    dw2, dgn, dwb, dwr = grads.split([c * c, 4 * c, j * c * c, r_num * c * c])
    cuda.call(
        "lane_plan", "lane_plan_bwd",
        cuda.ptr(feat), cuda.ptr(temp), cuda.ptr(masks), cuda.ptr(wb), cuda.ptr(w2),
        *(cuda.ptr(t) for t in gns), cuda.ptr(w_rel), cuda.ptr(prep.dst), cuda.ptr(prep.src),
        cuda.ptr(prep.tiles), cuda.ptr(prep.rel_tiles), cuda.ptr(prep.spos),
        cuda.ptr(prep.sseg), cuda.ptr(g), cuda.ptr(ws), cuda.ptr(dx), cuda.ptr(dpre), *parts,
        cuda.ptr(grads), cuda.ptr(dwb), cuda.ptr(dwr), ctypes.c_int(n), ctypes.c_int(c),
        ctypes.c_int(j),
        _shift_array(shifts), ctypes.c_longlong(slots), ctypes.c_int(r_num),
        ctypes.c_int(tail_blocks), ctypes.c_int(splits), ctypes.c_int(blocks),
        ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return (dx, dpre, dwb.view(j, c, c), dw2.view(c, c), *dgn.view(4, c).unbind(0),
            dwr.view(r_num, c, c))


class _LanePlan(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel (with temp) on
    CUDA tensors. Backward: `lane_plan_bwd_plain` / `lane_plan_bwd_cuda`;
    gradients go to feat, pre, wb, w2, the GN vectors and w_rel, each in its
    primal's dtype; the masks and the plan get None."""

    @staticmethod
    def forward(ctx, feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel, num_win,
                shifts, groups, eps, prep):
        if feat.device.type == "cpu":
            temp = _plan_temp_plain(feat, pre, masks, wb, shifts, w_rel, lu, lv, rel, num_win,
                                    groups)
            out = _tail_plain(feat, temp, w2, g1w, g1b, g2w, g2b, eps)
        else:
            out, temp = _plan_fwd_cuda(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu,
                                       lv, rel, num_win, shifts, groups, eps, prep,
                                       save_temp=True)
        ctx.save_for_backward(feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel)
        ctx.num_win, ctx.shifts, ctx.groups, ctx.eps = num_win, tuple(shifts), groups, eps
        ctx.pre_dtype, ctx.prep = pre.dtype, prep
        return out

    @staticmethod
    def backward(ctx, g):
        feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel = ctx.saved_tensors
        args = (feat, temp, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel, ctx.num_win,
                ctx.groups, g.to(feat.dtype).contiguous(), ctx.shifts, ctx.eps)
        if feat.device.type == "cpu":
            dx, dpre, dwb, dw2, *dgn, dwr = lane_plan_bwd_plain(*args)
        else:
            dx, dpre, dwb, dw2, *dgn, dwr = lane_plan_bwd_cuda(*args, ctx.prep)
        return (dx, dpre.to(ctx.pre_dtype), None, dwb.to(wb.dtype), dw2.to(w2.dtype),
                *(d.to(p.dtype) for d, p in zip(dgn, (g1w, g1b, g2w, g2b))),
                dwr.to(w_rel.dtype), None, None, None, None, None, None, None, None)


def fused_lane_layer_plan(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu, lv, rel,
                          num_win: int, shifts: Sequence[int], groups=None,
                          eps: float = 1e-5, prep=None) -> torch.Tensor:
    """relu(GN2(relu(GN1(pre + band_conv(feat) + plan_agg(feat))) @ w2) + feat).

    fused_lane_layer's arguments, plus w_rel [R, W, W] (in, out) in
    feat's dtype and the window plan lu/lv/rel [num_win*ECAP, 1] int32 with
    its relation groups (None: one group). N = num_win * t with t % 128 ==
    0; ECAP % 512 == 0. prep: the plan's `scenario_agg.prepare_plan` (made
    here when None; a LaneConv stack makes it once for its layers). CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lane_plan: unsupported device {feat.device}")
    _plan_check(feat, w_rel, lu, lv, rel, num_win)
    args = (feat.contiguous(), pre.contiguous(), masks, wb.contiguous(), w2.contiguous(),
            g1w, g1b, g2w, g2b, w_rel.contiguous(), lu, lv, rel)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _LanePlan.apply(*args, num_win, tuple(shifts), groups, eps, prep)
    if feat.device.type == "cpu":
        return lane_plan_plain(*args, num_win, shifts, groups, eps)
    return _plan_fwd_cuda(*args, num_win, shifts, groups, eps, prep)


def work_plan(feat, masks, lu, rel, w_rel, num_win: int, groups=None) -> dict:
    """`work`'s bytes and operations plus the plan's: its indices and W_rel
    read once, one [W, W] product (2·W² operations) per applied edge (its
    source rows are feat's, already counted)."""
    w = work(feat, masks)
    edges = plan_edge_count(lu, rel, num_win, groups, w_rel.shape[0])
    c, db = feat.shape[1], feat.element_size()
    w["bytes"] += 3 * lu.shape[0] * 4 + w_rel.numel() * db
    w["flops"] += 2 * edges * c * c
    w["edges"] = edges
    return w


def work_plan_bwd(feat, masks, lu, rel, w_rel, num_win: int, groups=None) -> dict:
    """`work_bwd`'s plus the plan's: its indices and W_rel read, dW_rel
    written, two [W, W] products per applied edge (dfeat and dW_rel)."""
    w = work_bwd(feat, masks)
    edges = plan_edge_count(lu, rel, num_win, groups, w_rel.shape[0])
    c, db = feat.shape[1], feat.element_size()
    w["bytes"] += 3 * lu.shape[0] * 4 + w_rel.numel() * (db + 4)
    w["flops"] += 2 * 2 * edges * c * c
    w["edges"] = edges
    return w
