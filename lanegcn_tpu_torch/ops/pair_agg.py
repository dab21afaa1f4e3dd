"""Window-pair aggregation of the LaneConv spill residue: the `pair_agg`
CUDA kernels (csrc/pair_agg.cu: the forward and the backward on the passes
they share with scenario_agg, csrc/rel_agg.cuh) and their plain versions.

    out[dwin*sd + lu] = temp + Σ_slots W_rel[rel] · feat[swin*ss + lv]

Counterpart of lanegcn_tpu/ops/pallas_pair_agg.py `pair_aggregate`. The
plan is the packer's spill plan (graph.PairPlan with the relation column:
idx [NC*chunk, 3] = lu, lv, rel with -1 padding; meta [6, NC]). The public op
runs through a `torch.autograd.Function` whose backward is the
`pair_agg_bwd` kernel on CUDA tensors and `pair_agg_bwd_plain` on CPU
tensors; temp's cotangent is the output's, unchanged.

The kernels, forward and backward, take rows W = 128 or 64 wide (`cuda.WIDTHS`).
The plain versions take any width.

Both kernels walk the plan as `prepare_spill` lists it (a
scenario_agg.PlanPrep: the valid slots in relation order, their 64-edge
single-relation tiles, their destination and, for the backward, source
positions), made once per LaneGCN forward and shared by MapNet's and M2M's
stacks, their layers and their backwards (a stack called without one makes
its own). Both the kernels and the plain versions add a row's edges in
relation order (slot order within a relation): the kernels sum over the
destination (source) order of the relation-ordered edges.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.scenario_agg import (PlanPrep, _arange, _blocks, _per_relation,
                                                 prepare_edges)


def _slot_rows(plan: PairPlan, n: int, num_rel: int):
    """Per plan slot: (valid, global dst row, global src row, relation). A
    slot is valid when lu and lv lie inside their windows, rel is a
    relation and both rows lie below n; the rows are read only where
    valid."""
    lu = plan.idx[:, 0].long()
    lv = plan.idx[:, 1].long()
    rel = plan.idx[:, 2].long()
    ch = _arange(lu.shape[0], lu.device) // plan.chunk
    u = plan.dwin.long()[ch] * plan.dst_stride + lu
    v = plan.swin.long()[ch] * plan.src_stride + lv
    ok = (lu >= 0) & (lu < plan.dst_stride) & (lv >= 0) & (lv < plan.src_stride)
    ok &= (rel >= 0) & (rel < num_rel) & (u < n) & (v < n)
    return ok, u, v, rel


def prepare_spill(plan: PairPlan, n: int, num_rel: int, backward: bool = True) -> PlanPrep:
    """The spill plan as the kernels walk it: its valid slots in relation
    order (one stable sort; slot order within a relation), their global
    rows, the relation-pure 64-edge tile table and each edge's position in
    destination and (with `backward`) source order. On the plan's device:
    no host sync."""
    ok, u, v, rel = _slot_rows(plan, n, num_rel)
    return prepare_edges(ok, rel, u, v, n, num_rel, backward)


def _sorted_slots(plan: PairPlan, n: int, num_rel: int):
    """Every plan slot in relation order, padding last: (global dst rows,
    global src rows, n on padding; each relation's edge count, host ints)."""
    ok, u, v, rel = _slot_rows(plan, n, num_rel)
    key, order = torch.sort(torch.where(ok, rel, num_rel), stable=True)
    live = key < num_rel
    counts = torch.bincount(key, minlength=num_rel + 1)[:num_rel].tolist()
    return torch.where(live, u[order], n), torch.where(live, v[order], n), counts


def _pad(x):
    """x with one zero row appended: the row a padding slot gathers, and
    the dropped row it adds into."""
    return F.pad(x, (0, 0, 0, 1))


def _messages(x, w_rel, counts, slots, transpose=False):
    """[slots] fp32 rows: each relation's run of x's rows times its W_r (or
    W_rᵀ), then zero rows for the padding slots."""
    msg = _per_relation(x[:sum(counts)], w_rel, counts, transpose)
    return F.pad(msg, (0, 0, 0, slots - msg.shape[0]))


def pair_agg_plain(feat, temp, w_rel, plan: PairPlan, prep=None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, over every plan slot: fp32
    messages (zero rows on padding), fp32 sum into temp with each row's
    edges in relation order, one rounding to temp's dtype. `prep` is
    accepted and not used."""
    n = feat.shape[0]
    u, v, counts = _sorted_slots(plan, n, w_rel.shape[0])
    msg = _messages(_pad(feat)[v].float(), w_rel, counts, u.shape[0])
    out = _pad(temp.float()).index_add_(0, u, msg)
    return out[:n].to(temp.dtype)


def pair_agg_bwd_plain(feat, w_rel, plan: PairPlan, g, prep=None):
    """The backward kernel's arithmetic, over every plan slot: per valid slot
    (u ← v, relation r) dfeat[v] += g[u] @ W_rᵀ (fp32 sums over the
    relation-ordered edges, one rounding to feat's dtype) and dW_r +=
    feat[v]ᵀ g[u] (fp32); padding slots gather zero rows. `prep` is
    accepted and not used. Returns (dfeat, dW_rel [R, W, W])."""
    n, c = feat.shape
    u, v, counts = _sorted_slots(plan, n, w_rel.shape[0])
    d_msg = _pad(g.to(feat.dtype))[u].float()
    gath = _pad(feat)[v].float()
    dw = torch.zeros(w_rel.shape, dtype=torch.float32, device=feat.device)
    o = 0
    for r, cnt in enumerate(counts):
        dw[r] = gath[o:o + cnt].t() @ d_msg[o:o + cnt]
        o += cnt
    d_gath = _messages(d_msg, w_rel, counts, u.shape[0], transpose=True)
    dfeat = torch.zeros(n + 1, c, dtype=torch.float32, device=feat.device).index_add_(0, v, d_gath)
    return dfeat[:n].to(feat.dtype), dw


def _check(feat, temp, w_rel, plan: PairPlan, name="pair_agg"):
    """Shapes and dtypes kernel `name` takes: feat/temp [N, W] with W in
    `cuda.WIDTHS` (64 or 128), w_rel [R, W, W], the spill plan with its relation
    column."""
    n, c = feat.shape
    r_num = w_rel.shape[0]
    nc = plan.num_chunks
    cuda.check_width(name, c)
    if (temp.shape != feat.shape or tuple(w_rel.shape) != (r_num, c, c)
            or not 0 < r_num <= 32 or plan.idx.dim() != 2 or plan.idx.shape[1] != 3
            or plan.idx.shape[0] != nc * plan.chunk or tuple(plan.meta.shape) != (6, nc)):
        raise ValueError(f"{name}: bad shapes feat {feat.shape} w_rel {w_rel.shape} "
                         f"plan idx {plan.idx.shape} meta {plan.meta.shape}")
    if temp.dtype != feat.dtype or w_rel.dtype != feat.dtype:
        raise TypeError(f"{name}: feat, temp and w_rel must share one dtype")
    if plan.idx.dtype != torch.int32 or plan.meta.dtype != torch.int32:
        raise TypeError(f"{name}: plan indices must be int32")


def _prep_for(plan: PairPlan, n: int, r_num: int, prep, backward: bool) -> PlanPrep:
    """`prep`, or the plan prepared now (with the source order where the
    backward needs it); a prepared plan of other sizes raises."""
    if prep is None or (backward and prep.spos is None):
        prep = prepare_spill(plan, n, r_num, backward)
    slots = plan.idx.shape[0]
    if (prep.dst.shape[0], prep.rel_edges.shape[0] - 1, prep.rows) != (slots, r_num, n):
        raise ValueError(f"pair_agg: the plan was prepared for {prep.dst.shape[0]} slots, "
                         f"{prep.rel_edges.shape[0] - 1} relations and {prep.rows} rows, "
                         f"not {slots}, {r_num} and {n}")
    return prep


def _fwd_cuda(feat, temp, w_rel, plan: PairPlan, prep: PlanPrep | None = None):
    _check(feat, temp, w_rel, plan)
    (n, c), r_num, slots = feat.shape, w_rel.shape[0], plan.idx.shape[0]
    prep = _prep_for(plan, n, r_num, prep, False)
    feat, temp, w_rel = (cuda.param(t, t.dtype) for t in (feat, temp, w_rel))
    code = cuda.check_cuda("pair_agg", feat, temp, w_rel, *prep[:7])
    ws = torch.empty(slots, c, dtype=torch.float32, device=feat.device)
    out = torch.empty_like(temp)
    cuda.call(
        "pair_agg", "pair_agg_fwd",
        cuda.ptr(feat), cuda.ptr(temp), cuda.ptr(w_rel), cuda.ptr(prep.src),
        cuda.ptr(prep.tiles), cuda.ptr(prep.rel_tiles), cuda.ptr(prep.dpos),
        cuda.ptr(prep.dseg), cuda.ptr(ws), cuda.ptr(out), ctypes.c_int(n), ctypes.c_int(c),
        ctypes.c_longlong(slots), ctypes.c_int(r_num), ctypes.c_int(_blocks(feat.device)),
        ctypes.c_int(code), cuda.stream(),
    )
    return out


def pair_agg_bwd_cuda(feat, w_rel, plan: PairPlan, g, prep: PlanPrep | None = None):
    """The `pair_agg_bwd` kernel; the same outputs as `pair_agg_bwd_plain`.
    `prep`: the plan's `prepare_spill` for feat's rows with the source order
    (made here when None or forward-only; a LaneGCN forward makes it once
    for both stacks)."""
    _check(feat, g, w_rel, plan, "pair_agg_bwd")
    (n, c), r_num, slots = feat.shape, w_rel.shape[0], plan.idx.shape[0]
    prep = _prep_for(plan, n, r_num, prep, True)
    feat, g, w_rel = (cuda.param(t, t.dtype) for t in (feat, g, w_rel))
    code = cuda.check_cuda("pair_agg", feat, g, w_rel, *prep[:9])
    blocks = _blocks(feat.device)
    f32 = dict(dtype=torch.float32, device=feat.device)
    ws = torch.empty(slots, c, **f32)
    dfeat = torch.empty_like(feat)
    part = torch.empty((blocks + r_num) * c * c, **f32)
    dw = torch.empty(r_num, c, c, **f32)
    cuda.call(
        "pair_agg", "pair_agg_bwd",
        cuda.ptr(feat), cuda.ptr(g), cuda.ptr(w_rel), cuda.ptr(prep.dst), cuda.ptr(prep.src),
        cuda.ptr(prep.tiles), cuda.ptr(prep.rel_tiles), cuda.ptr(prep.spos),
        cuda.ptr(prep.sseg), cuda.ptr(ws), cuda.ptr(dfeat), cuda.ptr(part), cuda.ptr(dw),
        ctypes.c_int(n), ctypes.c_int(c), ctypes.c_longlong(slots), ctypes.c_int(r_num), ctypes.c_int(blocks),
        ctypes.c_int(code), cuda.stream(),
    )
    return dfeat, dw


class _PairAgg(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors,
    on the plan's `prepare_spill` (the caller's, else made here). Backward:
    `pair_agg_bwd_plain` / `pair_agg_bwd_cuda` on the same preparation
    (made in the backward where it lacks the source order); temp's
    cotangent is g unchanged; the plan gets None."""

    @staticmethod
    def forward(ctx, feat, temp, w_rel, plan, prep):
        ctx.save_for_backward(feat, w_rel)
        ctx.plan, ctx.prep = plan, prep
        if feat.device.type == "cpu":
            return pair_agg_plain(feat, temp, w_rel, plan)
        return _fwd_cuda(feat, temp, w_rel, plan, prep)

    @staticmethod
    def backward(ctx, g):
        feat, w_rel = ctx.saved_tensors
        bwd = pair_agg_bwd_plain if feat.device.type == "cpu" else pair_agg_bwd_cuda
        dfeat, dw = bwd(feat, w_rel, ctx.plan, g.to(feat.dtype).contiguous(), ctx.prep)
        return dfeat, g, dw.to(w_rel.dtype), None, None


def pair_aggregate(feat, temp, w_rel, plan: PairPlan, prep: PlanPrep | None = None) -> torch.Tensor:
    """temp + Σ spill-plan edges W_rel[rel] · feat[src] added to dst.

    feat/temp [N, W] and w_rel [R, W, W] (in, out) in one dtype (W = 128 or
    64 on the card, both ways); plan:
    the pack's `spill_pair` (int32 idx with the relation column, meta);
    prep: the plan's `prepare_spill` for N rows and R relations, which the
    kernels walk (a LaneGCN forward makes it once for both stacks, with the
    source order when a gradient is wanted; None: the kernels make what they
    need). CPU tensors take the plain version; CUDA tensors launch the
    kernel. Rows no edge reaches keep temp.
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pair_agg: unsupported device {feat.device}")
    return _PairAgg.apply(feat.contiguous(), temp.contiguous(), w_rel.contiguous(), plan, prep)


def _edges_and_rows(feat, w_rel, plan: PairPlan):
    """(valid edges, distinct destination rows, distinct source rows)."""
    n = feat.shape[0]
    ok, u, v, _ = _slot_rows(plan, n, w_rel.shape[0])
    rows = lambda x: int((torch.where(ok, x, -1).unique() >= 0).sum())
    return int(ok.sum()), rows(u), rows(v)


def work(feat, w_rel, plan: PairPlan) -> dict:
    """Bytes moved and operations done at these inputs. The work depends on
    the plan's data: feat is read at the distinct source rows of valid
    slots; temp is read and the output written whole; the plan and W_rel are
    read once; the products (2·W² operations an edge at feat's width W) run
    on valid slots only. `slot_bytes` is apart: the fp32 message workspace
    [slots, W], 8·W bytes an edge written and read, traffic of the kernel's
    design and not of the function (as is the prepared plan)."""
    n, c = feat.shape
    db = feat.element_size()
    edges, dst_rows, src_rows = _edges_and_rows(feat, w_rel, plan)
    return {
        "bytes": (2 * n + src_rows) * c * db + plan.idx.numel() * 4 + plan.meta.numel() * 4
        + w_rel.numel() * db,
        "flops": 2 * edges * c * c,
        "edges": edges,
        "src_rows": src_rows,
        "dst_rows": dst_rows,
        "slot_bytes": 2 * edges * c * 4,
    }


def work_bwd(feat, w_rel, plan: PairPlan) -> dict:
    """The backward's bytes and operations at these inputs: g read at the
    distinct destination rows and feat at the distinct source rows of valid
    slots, dfeat written whole, the plan and W_rel read and dW_rel written;
    two products (dfeat, dW_rel, 2·W² operations each) per valid slot. (The
    kernel's own traffic adds the fp32 message workspace, a 4·W-byte row an
    edge written and read, and the prepared plan: not the function's.)"""
    n, c = feat.shape
    db = feat.element_size()
    edges, dst_rows, src_rows = _edges_and_rows(feat, w_rel, plan)
    return {
        "bytes": (n + dst_rows + src_rows) * c * db
        + plan.idx.numel() * 4 + plan.meta.numel() * 4 + w_rel.numel() * (db + 4),
        "flops": 2 * 2 * edges * c * c,
        "edges": edges,
    }
