"""Window-plan aggregation of LaneConv overflow edges: the `scenario_agg`
CUDA kernels (csrc/scenario_agg.cu, forward and backward) and their plain
versions.

    out[w*stride + lu] = temp + Σ_planned W_rel[rel] · feat[w*stride + lv]

Counterpart of lanegcn_tpu/ops/pallas_scenario_agg.py `scenario_aggregate`.
The plan is [W*ECAP, 1] int32 per leaf (lu, lv, rel; lu = -1 is padding),
prefix-dense per window and, with `groups`, chunk-aligned per relation
group: the slots of group g fill whole 512-slot chunks, and a chunk applies
only its group's relations (an unaligned plan under `groups` drops the
out-of-group edges, as on the TPU). Chunks past a window's last group end
are skipped. The public op runs through a `torch.autograd.Function`
whose backward is the `scenario_agg_bwd` kernel on
CUDA tensors and `scenario_agg_bwd_plain` on CPU tensors; temp's cotangent
is the output's, unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.ops import cuda

# Plan slot chunk; relation-grouped plans need at least two chunks per
# window. Shared with the packer (data/packing.py build_window_plan).
_CHUNK = 512
GROUPED_MIN_CAP = 2 * _CHUNK


def _groups(groups, num_rel: int):
    return (tuple(range(num_rel)),) if groups is None else tuple(tuple(g) for g in groups)


def group_chunk_ends(lu, rel, num_win: int, groups) -> torch.Tensor:
    """[W, G] int32 cumulative chunk ends per relation group: group g owns
    chunks [ends[:, g-1], ends[:, g]) of each window."""
    ecap = lu.shape[0] // num_win
    valid = (lu.reshape(num_win, ecap) >= 0)
    relw = rel.reshape(num_win, ecap)
    ends, total = [], torch.zeros(num_win, dtype=torch.int64, device=lu.device)
    for grp in groups:
        m = valid
        if len(groups) > 1:
            sel = torch.zeros_like(valid)
            for r in grp:
                sel |= relw == r
            m = valid & sel
        total = total + (m.sum(1) + _CHUNK - 1) // _CHUNK
        ends.append(total)
    return torch.stack(ends, 1).to(torch.int32).contiguous()


def _applied(lu, rel, num_win: int, groups) -> torch.Tensor:
    """[W*ECAP] bool: slots the kernel applies (valid, inside a visited chunk
    of its group, relation in that group)."""
    ecap = lu.shape[0] // num_win
    ends = group_chunk_ends(lu, rel, num_win, groups).long()  # [W, G]
    ck = (torch.arange(ecap, device=lu.device) // _CHUNK)[None, :]  # [1, ECAP]
    rel_w = rel.reshape(num_win, ecap).long()
    ok = torch.zeros(num_win, ecap, dtype=torch.bool, device=lu.device)
    lo = torch.zeros(num_win, 1, dtype=torch.int64, device=lu.device)
    for g, grp in enumerate(groups):
        hi = ends[:, g : g + 1]
        in_grp = torch.zeros_like(ok)
        for r in grp:
            in_grp |= rel_w == r
        ok |= (ck >= lo) & (ck < hi) & in_grp
        lo = hi
    return ok.reshape(-1) & (lu.reshape(-1) >= 0)


def plan_edges(lu, lv, rel, num_win: int, stride: int, groups, num_rel: int):
    """The slots the kernels apply (`_applied`), as flat destination and
    source rows sorted by relation (slot order within one), and the number
    of edges of each relation (host ints: the plain versions run on CPU
    tensors). No nonzero: the applied slots are those the sort puts first."""
    ecap = lu.shape[0] // num_win
    lu_f, lv_f, rel_f = lu.reshape(-1).long(), lv.reshape(-1).long(), rel.reshape(-1).long()
    ok = _applied(lu_f, rel_f, num_win, _groups(groups, num_rel))
    key = torch.where(ok, rel_f, num_rel)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=num_rel + 1)[:num_rel].tolist()
    base = torch.arange(num_win, device=lu.device).repeat_interleave(ecap) * stride
    return (base + lu_f)[order], (base + lv_f)[order], counts


def plan_applied(lu, rel, num_win: int, groups, num_rel: int) -> torch.Tensor:
    """[W*ECAP] bool: the slots the kernels apply."""
    return _applied(lu.reshape(-1).long(), rel.reshape(-1).long(), num_win,
                    _groups(groups, num_rel))


def plan_edge_count(lu, rel, num_win: int, groups, num_rel: int) -> int:
    """The number of slots the kernels apply."""
    return int(plan_applied(lu, rel, num_win, groups, num_rel).sum())


def _per_relation(x, w_rel, counts, transpose=False):
    """x's rows, in relation runs of `counts`, each run times its W_r (or
    W_rᵀ) in fp32."""
    outs, o = [], 0
    for r, c in enumerate(counts):
        w = w_rel[r].float()
        outs.append(x[o:o + c] @ (w.t() if transpose else w))
        o += c
    return torch.cat(outs) if outs else x[:0]


def scenario_agg_plain(feat, temp, w_rel, lu, lv, rel, num_win: int, groups=None):
    """The kernel's arithmetic in PyTorch: fp32 messages, fp32 sum into temp,
    one rounding to temp's dtype."""
    n = feat.shape[0]
    u, v, counts = plan_edges(lu, lv, rel, num_win, n // num_win, groups, w_rel.shape[0])
    k = sum(counts)
    msg = _per_relation(feat[v[:k]].float(), w_rel, counts)
    out = temp.to(torch.float32, copy=True).index_add_(0, u[:k], msg)
    return out.to(temp.dtype)


def scenario_agg_bwd_plain(feat, w_rel, lu, lv, rel, num_win: int, groups, g):
    """The backward kernel's arithmetic: per applied edge (u ← v, relation
    r), dfeat[v] += g[u] @ W_rᵀ (fp32 sums, one rounding to feat's dtype)
    and dW_r += feat[v]ᵀ g[u] (fp32). Returns (dfeat, dW_rel [R, 128, 128])."""
    n, c = feat.shape
    u, v, counts = plan_edges(lu, lv, rel, num_win, n // num_win, groups, w_rel.shape[0])
    k = sum(counts)
    u, v = u[:k], v[:k]
    d_msg = g.to(feat.dtype)[u].float()
    gath = feat[v].float()
    dw = torch.zeros(w_rel.shape, dtype=torch.float32, device=feat.device)
    o = 0
    for r, cnt in enumerate(counts):
        dw[r] = gath[o:o + cnt].t() @ d_msg[o:o + cnt]
        o += cnt
    d_gath = _per_relation(d_msg, w_rel, counts, transpose=True)
    dfeat = torch.zeros(n, c, dtype=torch.float32, device=feat.device).index_add_(0, v, d_gath)
    return dfeat.to(feat.dtype), dw


def _check(feat, temp, w_rel, lu, lv, rel, num_win):
    n, c = feat.shape
    r_num = w_rel.shape[0]
    if (c != 128 or temp.shape != feat.shape or n % num_win or lu.shape[0] % num_win
            or tuple(w_rel.shape) != (r_num, c, c) or not 0 < r_num <= 32
            or lv.shape != lu.shape or rel.shape != lu.shape or lu.numel() != lu.shape[0]):
        raise ValueError(f"scenario_agg: bad shapes feat {feat.shape} w_rel {w_rel.shape} "
                         f"plan {lu.shape} windows {num_win}")
    if temp.dtype != feat.dtype or w_rel.dtype != feat.dtype:
        raise TypeError("scenario_agg: feat, temp and w_rel must share one dtype")
    for t in (lu, lv, rel):
        if t.dtype != torch.int32:
            raise TypeError("scenario_agg: plan indices must be int32")


def _group_args(lu, rel, num_win, groups, r_num):
    groups = _groups(groups, r_num)
    ends = group_chunk_ends(lu, rel, num_win, groups)
    masks = (ctypes.c_uint * len(groups))(*(sum(1 << r for r in g) for g in groups))
    return groups, ends, masks


def _fwd_cuda(feat, temp, w_rel, lu, lv, rel, num_win, groups):
    _check(feat, temp, w_rel, lu, lv, rel, num_win)
    n = feat.shape[0]
    r_num = w_rel.shape[0]
    groups, ends, masks = _group_args(lu, rel, num_win, groups, r_num)
    code = cuda.check_cuda("scenario_agg", feat, temp, w_rel, lu, lv, rel, ends)
    out = torch.empty_like(temp)
    cuda.call(
        "scenario_agg", "scenario_agg_fwd",
        cuda.ptr(feat), cuda.ptr(temp), cuda.ptr(w_rel), cuda.ptr(lu), cuda.ptr(lv),
        cuda.ptr(rel), cuda.ptr(ends), ctypes.cast(masks, ctypes.c_void_p), cuda.ptr(out),
        ctypes.c_int(num_win), ctypes.c_int(n // num_win), ctypes.c_int(lu.shape[0] // num_win),
        ctypes.c_int(r_num), ctypes.c_int(len(groups)), ctypes.c_int(code), cuda.stream(),
    )
    return out


def scenario_agg_bwd_cuda(feat, w_rel, lu, lv, rel, num_win: int, groups, g):
    """The `scenario_agg_bwd` kernel; the same outputs as `scenario_agg_bwd_plain`."""
    _check(feat, g, w_rel, lu, lv, rel, num_win)
    n = feat.shape[0]
    r_num = w_rel.shape[0]
    groups, ends, masks = _group_args(lu, rel, num_win, groups, r_num)
    w_t = w_rel.transpose(1, 2).contiguous()
    code = cuda.check_cuda("scenario_agg", feat, g, w_t, lu, lv, rel, ends)
    splits = max(1, 2 * cuda.num_sms(feat.device) // r_num)
    dfeat = torch.empty_like(feat)
    part = torch.empty(splits * r_num * 128 * 128, dtype=torch.float32, device=feat.device)
    dw = torch.empty(r_num, 128, 128, dtype=torch.float32, device=feat.device)
    cuda.call(
        "scenario_agg", "scenario_agg_bwd",
        cuda.ptr(feat), cuda.ptr(g), cuda.ptr(w_t), cuda.ptr(lu), cuda.ptr(lv), cuda.ptr(rel),
        cuda.ptr(ends), ctypes.cast(masks, ctypes.c_void_p), cuda.ptr(dfeat), cuda.ptr(part),
        cuda.ptr(dw), ctypes.c_int(num_win), ctypes.c_int(n // num_win),
        ctypes.c_int(lu.shape[0] // num_win), ctypes.c_int(r_num), ctypes.c_int(len(groups)),
        ctypes.c_int(splits), ctypes.c_int(code), cuda.stream(),
    )
    return dfeat, dw


class _ScenarioAgg(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `scenario_agg_bwd_plain` / `scenario_agg_bwd_cuda`; temp's
    cotangent is g unchanged; the plan indices get None."""

    @staticmethod
    def forward(ctx, feat, temp, w_rel, lu, lv, rel, num_win, groups):
        ctx.save_for_backward(feat, w_rel, lu, lv, rel)
        ctx.num_win, ctx.groups = num_win, groups
        if feat.device.type == "cpu":
            return scenario_agg_plain(feat, temp, w_rel, lu, lv, rel, num_win, groups)
        return _fwd_cuda(feat, temp, w_rel, lu, lv, rel, num_win, groups)

    @staticmethod
    def backward(ctx, g):
        feat, w_rel, lu, lv, rel = ctx.saved_tensors
        bwd = scenario_agg_bwd_plain if feat.device.type == "cpu" else scenario_agg_bwd_cuda
        dfeat, dw = bwd(feat, w_rel, lu, lv, rel, ctx.num_win, ctx.groups,
                        g.to(feat.dtype).contiguous())
        return dfeat, g, dw.to(w_rel.dtype), None, None, None, None, None


def scenario_aggregate(feat, temp, w_rel, lu, lv, rel, num_win: int, groups=None):
    """temp + Σ planned edges W_rel[rel] · feat[src] added to dst.

    feat/temp [N, 128] (N = num_win * stride), w_rel [R, 128, 128] (in, out)
    in feat's dtype; lu/lv/rel [num_win*ECAP, 1] int32. CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scenario_agg: unsupported device {feat.device}")
    return _ScenarioAgg.apply(feat.contiguous(), temp.contiguous(), w_rel.contiguous(), lu, lv,
                              rel, num_win, groups)


def work(feat, lu, lv, rel, w_rel, num_win: int, groups=None) -> dict:
    """Bytes moved and operations done at these inputs. The work depends on
    the plan's data: feat is read at the distinct source rows of applied
    edges; temp is read and the output written whole; the plan and W_rel
    are read once; the products run on applied edges only."""
    n, c = feat.shape
    db = feat.element_size()
    ecap = lu.shape[0] // num_win
    groups = _groups(groups, w_rel.shape[0])
    lu_f, lv_f = lu.reshape(-1).long(), lv.reshape(-1).long()
    ok = _applied(lu_f, rel.reshape(-1).long(), num_win, groups)
    base = torch.arange(num_win, device=feat.device).repeat_interleave(ecap) * (n // num_win)
    src_rows = int((base + lv_f)[ok].unique().numel())
    edges = int(ok.sum())
    return {
        "bytes": (2 * n + src_rows) * c * db + 3 * lu.shape[0] * 4 + w_rel.numel() * db,
        "flops": 2 * edges * c * c,
        "edges": edges,
        "src_rows": src_rows,
    }


def work_bwd(feat, lu, lv, rel, w_rel, num_win: int, groups=None) -> dict:
    """The backward's bytes and operations at these inputs: g read at the
    distinct destination rows and feat at the distinct source rows of applied
    edges, dfeat written whole, the plan and W_rel read and dW_rel written;
    two products (dfeat, dW_rel) on applied edges only."""
    n, c = feat.shape
    db = feat.element_size()
    ecap = lu.shape[0] // num_win
    groups = _groups(groups, w_rel.shape[0])
    lu_f, lv_f = lu.reshape(-1).long(), lv.reshape(-1).long()
    ok = _applied(lu_f, rel.reshape(-1).long(), num_win, groups)
    base = torch.arange(num_win, device=feat.device).repeat_interleave(ecap) * (n // num_win)
    dst_rows = int((base + lu_f)[ok].unique().numel())
    src_rows = int((base + lv_f)[ok].unique().numel())
    edges = int(ok.sum())
    return {
        "bytes": (n + dst_rows + src_rows) * c * db + 3 * lu.shape[0] * 4
        + w_rel.numel() * (db + 4),
        "flops": 2 * 2 * edges * c * c,
        "edges": edges,
    }
