"""Window-pair aggregation of the LaneConv spill residue: the `pair_agg`
CUDA kernels (csrc/pair_agg.cu: forward, backward destination and source
passes) and their plain versions.

    out[dwin*sd + lu] = temp + Σ_slots W_rel[rel] · feat[swin*ss + lv]

Counterpart of lanegcn_tpu/ops/pallas_pair_agg.py `pair_aggregate`. The
plan is the packer's spill plan (graph.PairPlan with the relation column:
idx [NC*chunk, 3] = lu, lv, rel with -1 padding; meta [6, NC]). The public op
runs through a `torch.autograd.Function` whose backward is the two backward
kernels on CUDA tensors and `pair_agg_bwd_plain` on CPU tensors; temp's
cotangent is the output's, unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import cuda

C = 128
# Shared memory of a forward block: an fp32 [dst_stride, 32] window slice
# beside ~57 KB of tiles; of a source-pass block: an fp32 [src_stride, 32].
MAX_STRIDE = 1344


def _slots(plan: PairPlan, n: int, num_rel: int):
    """(valid slot positions, global dst rows, global src rows, relations)."""
    lu = plan.idx[:, 0].long()
    lv = plan.idx[:, 1].long()
    rel = plan.idx[:, 2].long()
    ch = torch.arange(lu.shape[0], device=lu.device) // plan.chunk
    u = plan.dwin.long()[ch] * plan.dst_stride + lu
    v = plan.swin.long()[ch] * plan.src_stride + lv
    ok = (lu >= 0) & (lu < plan.dst_stride) & (lv >= 0) & (lv < plan.src_stride)
    ok &= (rel >= 0) & (rel < num_rel) & (u < n) & (v < n)
    sel = ok.nonzero().squeeze(1)
    return sel, u[sel], v[sel], rel[sel]


def pair_agg_plain(feat, temp, w_rel, plan: PairPlan) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 messages, fp32 sum into
    temp, one rounding to temp's dtype."""
    _, u, v, rel = _slots(plan, feat.shape[0], w_rel.shape[0])
    src = feat[v].float()
    msg = torch.zeros(src.shape, dtype=torch.float32, device=feat.device)
    for r in range(w_rel.shape[0]):
        m = (rel == r).nonzero().squeeze(1)
        if m.numel():
            msg[m] = src[m] @ w_rel[r].float()
    out = temp.to(torch.float32, copy=True).index_add_(0, u, msg)
    return out.to(temp.dtype)


def pair_agg_bwd_plain(feat, w_rel, plan: PairPlan, g):
    """The backward kernels' arithmetic: per valid slot (u ← v, relation r)
    d_gath = g[u] @ W_rᵀ rounded to feat's dtype, dfeat[v] += d_gath (fp32
    sums, one rounding to feat's dtype) and dW_r += feat[v]ᵀ g[u] (fp32).
    Returns (dfeat, dW_rel [R, 128, 128])."""
    n, c = feat.shape
    _, u, v, rel = _slots(plan, n, w_rel.shape[0])
    d_msg = g.to(feat.dtype)[u].float()
    gath = feat[v].float()
    d_gath = torch.zeros_like(gath)
    dw = torch.zeros(w_rel.shape, dtype=torch.float32, device=feat.device)
    for r in range(w_rel.shape[0]):
        m = (rel == r).nonzero().squeeze(1)
        if m.numel():
            dw[r] = gath[m].t() @ d_msg[m]
            d_gath[m] = d_msg[m] @ w_rel[r].float().t()
    d_gath = d_gath.to(feat.dtype).float()
    dfeat = torch.zeros(n, c, dtype=torch.float32, device=feat.device).index_add_(0, v, d_gath)
    return dfeat.to(feat.dtype), dw


def _check(feat, temp, w_rel, plan: PairPlan):
    n, c = feat.shape
    r_num = w_rel.shape[0]
    nc = plan.num_chunks
    if (c != C or temp.shape != feat.shape or tuple(w_rel.shape) != (r_num, c, c)
            or not 0 < r_num <= 32 or plan.idx.dim() != 2 or plan.idx.shape[1] != 3
            or plan.idx.shape[0] != nc * plan.chunk or tuple(plan.meta.shape) != (6, nc)):
        raise ValueError(f"pair_agg: bad shapes feat {feat.shape} w_rel {w_rel.shape} "
                         f"plan idx {plan.idx.shape} meta {plan.meta.shape}")
    if not 0 < plan.dst_stride <= MAX_STRIDE or not 0 < plan.src_stride <= MAX_STRIDE:
        raise ValueError(f"pair_agg: windows of {plan.dst_stride}/{plan.src_stride} rows "
                         f"exceed {MAX_STRIDE}")
    if temp.dtype != feat.dtype or w_rel.dtype != feat.dtype:
        raise TypeError("pair_agg: feat, temp and w_rel must share one dtype")
    if plan.idx.dtype != torch.int32 or plan.meta.dtype != torch.int32:
        raise TypeError("pair_agg: plan indices must be int32")


def _plan_args(plan: PairPlan, n: int, r_num: int):
    return (ctypes.c_int(plan.num_chunks), ctypes.c_int(plan.chunk),
            ctypes.c_int(plan.dst_stride), ctypes.c_int(plan.src_stride), ctypes.c_int(n),
            ctypes.c_int(r_num))


def _fwd_cuda(feat, temp, w_rel, plan: PairPlan):
    _check(feat, temp, w_rel, plan)
    code = cuda.check_cuda("pair_agg", feat, temp, w_rel, plan.idx, plan.meta)
    out = temp.clone()
    cuda.call(
        "pair_agg", "pair_agg_fwd",
        cuda.ptr(feat), cuda.ptr(temp), cuda.ptr(w_rel), cuda.ptr(plan.idx), cuda.ptr(plan.meta),
        cuda.ptr(out), *_plan_args(plan, feat.shape[0], w_rel.shape[0]), ctypes.c_int(code),
        cuda.stream(),
    )
    return out


def pair_agg_bwd_cuda(feat, w_rel, plan: PairPlan, g):
    """The `pair_agg_bwd_d` and `pair_agg_bwd_s` kernels; the same outputs as
    `pair_agg_bwd_plain`."""
    _check(feat, g, w_rel, plan)
    n = feat.shape[0]
    r_num = w_rel.shape[0]
    dev = feat.device
    w_t = w_rel.transpose(1, 2).contiguous()
    code = cuda.check_cuda("pair_agg", feat, g, w_t, plan.idx, plan.meta)
    splits = max(1, 2 * cuda.num_sms(dev) // r_num)
    d_gath = torch.zeros(plan.idx.shape[0], C, dtype=feat.dtype, device=dev)
    part = torch.empty(splits * r_num * C * C, dtype=torch.float32, device=dev)
    dw = torch.empty(r_num, C, C, dtype=torch.float32, device=dev)
    pa = _plan_args(plan, n, r_num)
    cuda.call(
        "pair_agg", "pair_agg_bwd_d",
        cuda.ptr(feat), cuda.ptr(g), cuda.ptr(w_t), cuda.ptr(plan.idx), cuda.ptr(plan.meta),
        cuda.ptr(d_gath), cuda.ptr(part), cuda.ptr(dw), *pa, ctypes.c_int(splits),
        ctypes.c_int(code), cuda.stream(),
    )
    dfeat = torch.zeros_like(feat)
    cuda.call(
        "pair_agg", "pair_agg_bwd_s",
        cuda.ptr(d_gath), cuda.ptr(plan.idx), cuda.ptr(plan.meta), cuda.ptr(dfeat), *pa,
        ctypes.c_int(code), cuda.stream(),
    )
    return dfeat, dw


class _PairAgg(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `pair_agg_bwd_plain` / `pair_agg_bwd_cuda`; temp's cotangent
    is g unchanged; the plan gets None."""

    @staticmethod
    def forward(ctx, feat, temp, w_rel, plan):
        ctx.save_for_backward(feat, w_rel)
        ctx.plan = plan
        if feat.device.type == "cpu":
            return pair_agg_plain(feat, temp, w_rel, plan)
        return _fwd_cuda(feat, temp, w_rel, plan)

    @staticmethod
    def backward(ctx, g):
        feat, w_rel = ctx.saved_tensors
        bwd = pair_agg_bwd_plain if feat.device.type == "cpu" else pair_agg_bwd_cuda
        dfeat, dw = bwd(feat, w_rel, ctx.plan, g.to(feat.dtype).contiguous())
        return dfeat, g, dw.to(w_rel.dtype), None


def pair_aggregate(feat, temp, w_rel, plan: PairPlan) -> torch.Tensor:
    """temp + Σ spill-plan edges W_rel[rel] · feat[src] added to dst.

    feat/temp [N, 128] and w_rel [R, 128, 128] (in, out) in one dtype; plan:
    the pack's `spill_pair` (int32 idx with the relation column, meta).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Destination windows no chunk touches keep temp.
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_agg: unsupported device {feat.device}")
    return _PairAgg.apply(feat.contiguous(), temp.contiguous(), w_rel.contiguous(), plan)


def work(feat, w_rel, plan: PairPlan) -> dict:
    """Bytes moved and operations done at these inputs. The work depends on
    the plan's data: feat is read at the distinct source rows of valid
    slots; temp is read and the output written whole; the plan and W_rel are
    read once; the products run on valid slots only."""
    n, c = feat.shape
    db = feat.element_size()
    sel, u, v, _ = _slots(plan, n, w_rel.shape[0])
    src_rows = int(v.unique().numel())
    return {
        "bytes": (2 * n + src_rows) * c * db + plan.idx.numel() * 4 + plan.meta.numel() * 4
        + w_rel.numel() * db,
        "flops": 2 * int(sel.numel()) * c * c,
        "edges": int(sel.numel()),
        "src_rows": src_rows,
        "dst_rows": int(u.unique().numel()),
    }


def work_bwd(feat, w_rel, plan: PairPlan) -> dict:
    """The backward's bytes and operations at these inputs: g read at the
    distinct destination rows and feat at the distinct source rows of valid
    slots, dfeat written whole, the plan and W_rel read and dW_rel written;
    two products (d_gath, dW_rel) per valid slot. `slot_bytes` is apart: the
    d_gath rows the destination pass writes and the source pass reads back,
    traffic of the two-pass design and not of the function."""
    n, c = feat.shape
    db = feat.element_size()
    sel, u, v, _ = _slots(plan, n, w_rel.shape[0])
    e = int(sel.numel())
    return {
        "bytes": (n + int(u.unique().numel()) + int(v.unique().numel())) * c * db
        + plan.idx.numel() * 4 + plan.meta.numel() * 4 + w_rel.numel() * (db + 4),
        "flops": 2 * 2 * e * c * c,
        "edges": e,
        "slot_bytes": 2 * e * c * db,
    }
