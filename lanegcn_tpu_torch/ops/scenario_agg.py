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
are skipped.

On the card the plan is first prepared (`prepare_plan`, once per LaneConv
stack call, shared by its layers and their backwards): the applied edges in
relation order, cut into 64-edge tiles of one relation each, with each
edge's position in destination (and source) order. The kernels then write
each tile's fp32 messages to their positions and sum them in a fixed order
into the destination rows (csrc/scenario_agg.cu). The public op runs
through a `torch.autograd.Function` whose backward is the
`scenario_agg_bwd` kernel on CUDA tensors and `scenario_agg_bwd_plain` on
CPU tensors; temp's cotangent is the output's, unchanged.

The kernels, forward and backward, take rows W = 128 or 64 wide (`cuda.WIDTHS`).
The plain versions take any width.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from lanegcn_tpu_torch.ops import cuda


# Plan slot chunk; relation-grouped plans need at least two chunks per
# window. Shared with the packer (data/packing.py build_window_plan).
_CHUNK = 512
GROUPED_MIN_CAP = 2 * _CHUNK


def _groups(groups, num_rel: int):
    return (tuple(range(num_rel)),) if groups is None else tuple(tuple(g) for g in groups)


_CONSTANTS: dict = {}


def _constant(key, device, make) -> torch.Tensor:
    """A small constant tensor (a relation-group table, a range), made once
    per device and kept: the plan preparation then copies nothing from the
    host and launches fewer kernels."""
    k = (key, str(device))
    if k not in _CONSTANTS:
        _CONSTANTS[k] = make()
    return _CONSTANTS[k]


def _arange(n: int, device, dtype=torch.int64) -> torch.Tensor:
    return _constant(("arange", n, dtype), device,
                     lambda: torch.arange(n, dtype=dtype, device=device))


def _group_table(groups, device) -> torch.Tensor:
    """[size + 2] int64: the group of relation r at r + 1 (filled with
    scalars, so nothing is copied from the host); -1 at 0 (no relation,
    r = -1) and for a relation outside every group."""
    size = max(max(g) for g in groups if g) + 1

    def make():
        table = torch.full((size + 2,), -1, dtype=torch.int64, device=device)
        for g, grp in enumerate(groups):
            for r in grp:
                table[r + 1] = g
        return table

    return _constant(("groups", groups), device, make)


def _slot_groups(lu, rel, groups) -> torch.Tensor:
    """[W*ECAP] int64: each valid slot's relation group; -1 for padding and
    for a relation outside every group."""
    table = _group_table(groups, lu.device)
    g = table[(rel.reshape(-1).long() + 1).clamp(0, table.shape[0] - 1)]
    return torch.where(lu.reshape(-1) >= 0, g, -1)


def _chunk_ends(lu, num_win: int, groups, sg) -> torch.Tensor:
    """[W, G] int64 cumulative 512-slot chunk ends per relation group (sg:
    `_slot_groups`; one group counts every valid slot)."""
    if len(groups) == 1:
        per = (lu.reshape(num_win, -1) >= 0).sum(1, keepdim=True)
    else:
        sgw = sg.reshape(num_win, -1)
        per = torch.stack([(sgw == g).sum(1) for g in range(len(groups))], 1)
    return ((per + _CHUNK - 1) // _CHUNK).cumsum(1)


def _applied(lu, rel, num_win: int, groups) -> torch.Tensor:
    """[W*ECAP] bool: slots the kernel applies (valid, inside a visited chunk
    of its group, relation in that group)."""
    ecap = lu.shape[0] // num_win
    sg = _slot_groups(lu, rel, groups)
    ends = _chunk_ends(lu, num_win, groups, sg)  # [W, G]
    ck = _constant(("chunk", ecap), lu.device,
                   lambda: torch.arange(ecap, device=lu.device) // _CHUNK)
    chunk_group = (ck[None, :, None] >= ends[:, None, :]).sum(2)  # G past the last
    return (sg.reshape(num_win, ecap) == chunk_group).reshape(-1)


def _applied_edges(lu, lv, rel, num_win: int, stride: int, groups, num_rel: int):
    """[W*ECAP] bool: the slots the kernels apply (`_applied`), both rows
    inside their window."""
    lu_f, lv_f = lu.reshape(-1), lv.reshape(-1)
    return (_applied(lu_f, rel, num_win, _groups(groups, num_rel))
            & (torch.maximum(lu_f, lv_f) < stride) & (lv_f >= 0))


def _rows(idx, num_win: int, stride: int) -> torch.Tensor:
    """[W*ECAP] int64 global rows of window-local plan indices."""
    ecap = idx.shape[0] // num_win
    return _arange(idx.shape[0], idx.device) // ecap * stride + idx.reshape(-1)


def plan_edges(lu, lv, rel, num_win: int, stride: int, groups, num_rel: int):
    """The slots the kernels apply (`_applied_edges`), as flat destination
    and source rows sorted by relation (slot order within one), and the
    number of edges of each relation (host ints: the plain versions run on
    CPU tensors). No compaction that syncs the host: the applied slots
    are those the sort puts first."""
    ok = _applied_edges(lu, lv, rel, num_win, stride, groups, num_rel)
    key = torch.where(ok, rel.reshape(-1).long(), num_rel)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=num_rel + 1)[:num_rel].tolist()
    return _rows(lu, num_win, stride)[order], _rows(lv, num_win, stride)[order], counts


def plan_applied(lu, rel, num_win: int, groups, num_rel: int) -> torch.Tensor:
    """[W*ECAP] bool: the valid slots that lie inside a visited chunk of
    their relation group (the alignment `check_plan_groups` asserts)."""
    return _applied(lu.reshape(-1), rel.reshape(-1), num_win, _groups(groups, num_rel))


def plan_edge_count(lu, rel, num_win: int, groups, num_rel: int) -> int:
    """The number of slots the kernels apply."""
    return int(plan_applied(lu, rel, num_win, groups, num_rel).sum())


# --- the plan, prepared for the kernels ---------------------------------------

TILE = 64  # edges per tile of the message and dW passes (one relation each)


class PlanPrep(NamedTuple):
    """The window plan as the kernels walk it, made once per LaneConv stack
    call (`prepare_plan`) and shared by its layers and their backwards.
    Over the S = W*ECAP plan slots; E applied edges, listed in relation
    order (one stable sort of the slots), take entries [0, E):

    dst, src   [S] int32 global destination / source rows (n past E)
    rel_edges  [R+1] int32 each relation's first edge (rel_edges[R] = E)
    rel_tiles  [R+1] int32 each relation's first tile (rel_tiles[R]: the
               live tiles)
    tiles      [⌈S/64⌉ + R, 3] int32 (relation, first edge, edges ≤ 64) of
               each tile, one relation per tile; -1, 0, 0 past the live ones
    dpos, dseg [S] int32 each edge's position in destination order, and
               int64 the destination row at each position (n past E):
               the forward's segment sum
    spos, sseg the same in source order (the backward's dfeat), or None
    rows       n, the node rows it was prepared for (the kernels' mark of a
               position that holds no edge)
    """

    dst: torch.Tensor
    src: torch.Tensor
    rel_edges: torch.Tensor
    rel_tiles: torch.Tensor
    tiles: torch.Tensor
    dpos: torch.Tensor
    dseg: torch.Tensor
    spos: Optional[torch.Tensor]
    sseg: Optional[torch.Tensor]
    rows: int


def _positions(keys: torch.Tensor):
    """(each entry's position in the stable order of keys, int32; the keys
    in that order)."""
    seg, perm = torch.sort(keys, stable=True)
    pos = torch.empty_like(perm).scatter_(0, perm, _arange(perm.shape[0], perm.device))
    return pos.to(torch.int32), seg


def prepare_plan(lu, lv, rel, num_win: int, stride: int, groups, num_rel: int,
                 backward: bool = True) -> PlanPrep:
    """The plan's applied edges in relation order, their single-relation
    tiles and their destination (and, with `backward`, source) positions.
    Sorts, searches and scatters on the plan's device: no host sync."""
    lu_f, lv_f, rel_f = lu.reshape(-1), lv.reshape(-1), rel.reshape(-1).long()
    ok = _applied_edges(lu_f, lv_f, rel_f, num_win, stride, groups, num_rel)
    return prepare_edges(ok, rel_f, _rows(lu, num_win, stride), _rows(lv, num_win, stride),
                         num_win * stride, num_rel, backward)


def prepare_edges(ok, rel, u, v, n: int, num_rel: int, backward: bool = True) -> PlanPrep:
    """A PlanPrep from one entry per plan slot: whether the slot is an edge
    the kernels apply (`ok`), its relation and its global destination and
    source rows (read only where ok). The edges in relation order (one stable
    sort; slot order within a relation), the tile table and the positions:
    the window plan's (`prepare_plan`) and the spill plan's
    (ops/pair_agg.py `prepare_spill`)."""
    slots, dev = ok.shape[0], ok.device
    key, order = torch.sort(torch.where(ok, rel.long(), num_rel), stable=True)
    live = key < num_rel
    dst = torch.where(live, u[order], n)
    src = torch.where(live, v[order], n)
    rel_edges = torch.searchsorted(key, _arange(num_rel + 1, dev))  # [R+1]
    rel_tiles = F.pad(((rel_edges.diff() + TILE - 1) // TILE).cumsum(0), (1, 0))
    # Tile t: relation r_t (num_rel past the live tiles), its first edge and
    # edge count.
    t = _arange(-(-slots // TILE) + num_rel, dev)
    r_t = torch.searchsorted(rel_tiles[1:], t, right=True)
    r_c = r_t.clamp(max=num_rel - 1)
    first = rel_edges[r_c] + (t - rel_tiles[r_c]) * TILE
    cnt = (rel_edges[r_c + 1] - first).clamp(max=TILE)
    live_t = r_t < num_rel
    tiles = torch.stack([torch.where(live_t, r_t, -1), first * live_t, cnt * live_t], 1)
    dpos, dseg = _positions(dst)
    spos, sseg = _positions(src) if backward else (None, None)
    i32 = lambda x: x.to(torch.int32)
    return PlanPrep(i32(dst), i32(src), i32(rel_edges), i32(rel_tiles), i32(tiles), dpos, dseg,
                    spos, sseg, n)


def _per_relation(x, w_rel, counts, transpose=False):
    """x's rows, in relation runs of `counts`, each run times its W_r (or
    W_rᵀ) in fp32."""
    outs, o = [], 0
    for r, c in enumerate(counts):
        w = w_rel[r].float()
        outs.append(x[o:o + c] @ (w.t() if transpose else w))
        o += c
    return torch.cat(outs) if outs else x[:0]


def scenario_agg_plain(feat, temp, w_rel, lu, lv, rel, num_win: int, groups=None, prep=None):
    """The kernel's arithmetic in PyTorch: fp32 messages, fp32 sum into temp
    (each row's edges in relation order), one rounding to temp's dtype.
    Works from the plan itself; `prep` is accepted and not used."""
    n = feat.shape[0]
    u, v, counts = plan_edges(lu, lv, rel, num_win, n // num_win, groups, w_rel.shape[0])
    k = sum(counts)
    msg = _per_relation(feat[v[:k]].float(), w_rel, counts)
    out = temp.to(torch.float32, copy=True).index_add_(0, u[:k], msg)
    return out.to(temp.dtype)


def scenario_agg_bwd_plain(feat, w_rel, lu, lv, rel, num_win: int, groups, g, prep=None):
    """The backward kernel's arithmetic: per applied edge (u ← v, relation
    r), dfeat[v] += g[u] @ W_rᵀ (fp32 sums, one rounding to feat's dtype)
    and dW_r += feat[v]ᵀ g[u] (fp32). Returns (dfeat, dW_rel [R, W, W])."""
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


def _check(feat, temp, w_rel, lu, lv, rel, num_win, name="scenario_agg"):
    """Shapes and dtypes kernel `name` takes: feat/temp [N, W] with W in
    `cuda.WIDTHS` (64 or 128), w_rel [R, W, W], the plan [num_win*ECAP, 1]
    int32."""
    n, c = feat.shape
    r_num = w_rel.shape[0]
    cuda.check_width(name, c)
    if (temp.shape != feat.shape or n % num_win or lu.shape[0] % num_win
            or tuple(w_rel.shape) != (r_num, c, c) or not 0 < r_num <= 32
            or lv.shape != lu.shape or rel.shape != lu.shape or lu.numel() != lu.shape[0]):
        raise ValueError(f"{name}: bad shapes feat {feat.shape} w_rel {w_rel.shape} "
                         f"plan {lu.shape} windows {num_win}")
    if temp.dtype != feat.dtype or w_rel.dtype != feat.dtype:
        raise TypeError(f"{name}: feat, temp and w_rel must share one dtype")
    for t in (lu, lv, rel):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: plan indices must be int32")


def _prep_for(lu, lv, rel, num_win, n, groups, r_num, prep, backward):
    """`prep`, or the plan prepared now (with the source order where the
    backward needs it); a plan prepared for other rows raises."""
    if prep is None or (backward and prep.spos is None):
        prep = prepare_plan(lu, lv, rel, num_win, n // num_win, groups, r_num, backward)
    if prep.rows != n:
        raise ValueError(f"scenario_agg: the plan was prepared for {prep.rows} rows, not {n}")
    return prep


def _blocks(device) -> int:
    """Persistent blocks of the message and dW passes: two per SM (each
    holds ~100 KB of shared memory)."""
    return 2 * cuda.num_sms(device)


def _fwd_cuda(feat, temp, w_rel, lu, lv, rel, num_win, groups, prep=None):
    _check(feat, temp, w_rel, lu, lv, rel, num_win)
    (n, c), r_num, slots = feat.shape, w_rel.shape[0], lu.shape[0]
    prep = _prep_for(lu, lv, rel, num_win, n, groups, r_num, prep, False)
    feat, temp, w_rel = (cuda.param(t, t.dtype) for t in (feat, temp, w_rel))
    code = cuda.check_cuda("scenario_agg", feat, temp, w_rel, *prep[:7])
    ws = torch.empty(slots, c, dtype=torch.float32, device=feat.device)
    out = torch.empty_like(temp)
    cuda.call(
        "scenario_agg", "scenario_agg_fwd",
        cuda.ptr(feat), cuda.ptr(temp), cuda.ptr(w_rel), cuda.ptr(prep.src),
        cuda.ptr(prep.tiles), cuda.ptr(prep.rel_tiles), cuda.ptr(prep.dpos),
        cuda.ptr(prep.dseg), cuda.ptr(ws), cuda.ptr(out), ctypes.c_int(n), ctypes.c_int(c),
        ctypes.c_longlong(slots), ctypes.c_int(r_num), ctypes.c_int(_blocks(feat.device)),
        ctypes.c_int(code), cuda.stream(),
    )
    return out


def scenario_agg_bwd_cuda(feat, w_rel, lu, lv, rel, num_win: int, groups, g, prep=None):
    """The `scenario_agg_bwd` kernel; the same outputs as `scenario_agg_bwd_plain`."""
    _check(feat, g, w_rel, lu, lv, rel, num_win, "scenario_agg_bwd")
    (n, c), r_num, slots = feat.shape, w_rel.shape[0], lu.shape[0]
    prep = _prep_for(lu, lv, rel, num_win, n, groups, r_num, prep, True)
    feat, g, w_rel = (cuda.param(t, t.dtype) for t in (feat, g, w_rel))
    code = cuda.check_cuda("scenario_agg", feat, g, w_rel, *prep[:9])
    blocks = _blocks(feat.device)
    f32 = dict(dtype=torch.float32, device=feat.device)
    ws = torch.empty(slots, c, **f32)
    dfeat = torch.empty_like(feat)
    part = torch.empty((blocks + r_num) * c * c, **f32)
    dw = torch.empty(r_num, c, c, **f32)
    cuda.call(
        "scenario_agg", "scenario_agg_bwd",
        cuda.ptr(feat), cuda.ptr(g), cuda.ptr(w_rel), cuda.ptr(prep.dst), cuda.ptr(prep.src),
        cuda.ptr(prep.tiles), cuda.ptr(prep.rel_tiles), cuda.ptr(prep.spos),
        cuda.ptr(prep.sseg), cuda.ptr(ws), cuda.ptr(dfeat), cuda.ptr(part), cuda.ptr(dw),
        ctypes.c_int(n), ctypes.c_int(c), ctypes.c_longlong(slots), ctypes.c_int(r_num), ctypes.c_int(blocks),
        ctypes.c_int(code), cuda.stream(),
    )
    return dfeat, dw


class _ScenarioAgg(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `scenario_agg_bwd_plain` / `scenario_agg_bwd_cuda`; temp's
    cotangent is g unchanged; the plan indices get None."""

    @staticmethod
    def forward(ctx, feat, temp, w_rel, lu, lv, rel, num_win, groups, prep):
        ctx.save_for_backward(feat, w_rel, lu, lv, rel)
        ctx.num_win, ctx.groups, ctx.prep = num_win, groups, prep
        if feat.device.type == "cpu":
            return scenario_agg_plain(feat, temp, w_rel, lu, lv, rel, num_win, groups)
        return _fwd_cuda(feat, temp, w_rel, lu, lv, rel, num_win, groups, prep)

    @staticmethod
    def backward(ctx, g):
        feat, w_rel, lu, lv, rel = ctx.saved_tensors
        bwd = scenario_agg_bwd_plain if feat.device.type == "cpu" else scenario_agg_bwd_cuda
        dfeat, dw = bwd(feat, w_rel, lu, lv, rel, ctx.num_win, ctx.groups,
                        g.to(feat.dtype).contiguous(), ctx.prep)
        return dfeat, g, dw.to(w_rel.dtype), None, None, None, None, None, None


def scenario_aggregate(feat, temp, w_rel, lu, lv, rel, num_win: int, groups=None, prep=None):
    """temp + Σ planned edges W_rel[rel] · feat[src] added to dst.

    feat/temp [N, W] (N = num_win * stride; W = 128 or 64 on the card, both
    ways), w_rel [R, W, W] (in, out) in feat's dtype;
    lu/lv/rel [num_win*ECAP, 1] int32; prep: the plan's `prepare_plan`
    (made here when None; a LaneConv stack makes it once for its layers).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scenario_agg: unsupported device {feat.device}")
    return _ScenarioAgg.apply(feat.contiguous(), temp.contiguous(), w_rel.contiguous(), lu, lv,
                              rel, num_win, groups, prep)


def _rows_touched(lu, lv, rel, num_win, n, groups, num_rel):
    """(applied edges, distinct destination rows, distinct source rows)."""
    stride = n // num_win
    ok = _applied_edges(lu, lv, rel, num_win, stride, groups, num_rel)
    rows = lambda x: int(_rows(x, num_win, stride)[ok].unique().numel())
    return int(ok.sum()), rows(lu), rows(lv)


def work(feat, lu, lv, rel, w_rel, num_win: int, groups=None) -> dict:
    """Bytes moved and operations done at these inputs. The work depends on
    the plan's data: feat is read at the distinct source rows of applied
    edges; temp is read and the output written whole; the plan and W_rel
    are read once; the products (2·W² operations an edge at feat's width W)
    run on applied edges only. `slot_bytes` is apart: the fp32 message
    workspace [slots, W] the message pass writes and the segment sum reads
    back, traffic of the kernel's design and not of the function (as is the
    prepared plan)."""
    n, c = feat.shape
    db = feat.element_size()
    edges, _, src_rows = _rows_touched(lu, lv, rel, num_win, n, groups, w_rel.shape[0])
    return {
        "bytes": (2 * n + src_rows) * c * db + 3 * lu.shape[0] * 4 + w_rel.numel() * db,
        "flops": 2 * edges * c * c,
        "edges": edges,
        "src_rows": src_rows,
        "slot_bytes": 2 * edges * c * 4,
    }


def work_bwd(feat, lu, lv, rel, w_rel, num_win: int, groups=None) -> dict:
    """The backward's bytes and operations at these inputs: g read at the
    distinct destination rows and feat at the distinct source rows of applied
    edges, dfeat written whole, the plan and W_rel read and dW_rel written;
    two products (dfeat, dW_rel) on applied edges only."""
    n, c = feat.shape
    db = feat.element_size()
    edges, dst_rows, src_rows = _rows_touched(lu, lv, rel, num_win, n, groups, w_rel.shape[0])
    return {
        "bytes": (n + dst_rows + src_rows) * c * db + 3 * lu.shape[0] * 4
        + w_rel.numel() * (db + 4),
        "flops": 2 * 2 * edges * c * c,
        "edges": edges,
    }
