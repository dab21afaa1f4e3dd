"""Pack variable-size scenarios into static-shape PackedBatch pytrees.

Replaces the reference's on-GPU actor_gather/graph_gather merge
(reference lanegcn.py:155-209) and the on-the-fly fusion-edge construction
inside Att (lanegcn.py:672-689): everything dynamic is resolved here on host,
with pack-global indices baked into fixed-capacity buffers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from lanegcn_tpu_torch.config import ModelConfig, PackConfig, band_shift, relation_names
from lanegcn_tpu_torch.graph import (
    ActorBatch,
    EdgeSet,
    FusionEdges,
    LaneGraphBatch,
    PackedBatch,
    PairPlan,
)
from lanegcn_tpu_torch.ops.window_scatter import WCHUNK


def _pad_edges(u: np.ndarray, v: np.ndarray, capacity: int) -> Tuple[EdgeSet, int]:
    """Pad (or truncate, counting drops) an edge list to capacity."""
    n = len(u)
    dropped = max(0, n - capacity)
    n = min(n, capacity)
    uu = np.zeros(capacity, np.int32)
    vv = np.zeros(capacity, np.int32)
    mm = np.zeros(capacity, bool)
    uu[:n], vv[:n], mm[:n] = u[:n], v[:n], True
    return EdgeSet(u=uu, v=vv, mask=mm), dropped


def _pad_edges_sorted(
    u: np.ndarray, v: np.ndarray, capacity: int, num_src: int
) -> Tuple[EdgeSet, int]:
    """_pad_edges with the destination-sorted layout + source-side inverse.

    Edges are sorted by destination u (so consumers scatter with
    indices_are_sorted), and the EdgeSet carries inv_perm/inv_dst — the
    argsort of v with padding routed to the num_src drop sentinel — so the
    source gather's backward is one permute + one sorted scatter (the JAX
    package's ops.table_gather.sorted_transpose_gather; the port's
    ops/scatter.py `src_order`)."""
    order = np.argsort(u, kind="stable")
    u, v = np.asarray(u)[order], np.asarray(v)[order]
    es, dropped = _pad_edges(u, v, capacity)
    n = min(len(u), capacity)
    inv_perm = np.full(capacity, max(capacity - 1, 0), np.int32)
    inv_dst = np.full(capacity, num_src, np.int32)
    if n:
        o2 = np.argsort(v[:n], kind="stable").astype(np.int32)
        inv_perm[:n] = o2
        inv_dst[:n] = v[:n][o2]
    return (
        EdgeSet(u=es.u, v=es.v, mask=es.mask, inv_perm=inv_perm, inv_dst=inv_dst),
        dropped,
    )


def window_chunked_edges(
    u: np.ndarray, v: np.ndarray, capacity: int, dst_stride: int, num_src: int
) -> Tuple[EdgeSet, int]:
    """_pad_edges_sorted, additionally CHUNK-ALIGNED per destination window.

    Edges are sorted by destination, then each destination window's segment
    (window = u // dst_stride) is padded to a multiple of WCHUNK so no chunk
    straddles two windows. The EdgeSet carries win_lu / win_chunk /
    win_first for ops/window_scatter.window_scatter_add plus the usual
    source-side inverse. Alignment costs ≤ WCHUNK - 1 padded slots per
    occupied window; windows that no longer fit the aligned capacity drop
    their tail edges (counted in the return)."""
    W = WCHUNK
    assert capacity % W == 0, (capacity, W)
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    nch = capacity // W
    uu = np.zeros(capacity, np.int32)
    vv = np.zeros(capacity, np.int32)
    mm = np.zeros(capacity, bool)
    lu = np.full(capacity, -1, np.int32)
    wchunk = np.zeros(nch, np.int32)
    first = np.zeros(nch, np.int32)
    dropped = 0
    pos = 0  # next free chunk
    if len(u):
        win = u // dst_stride
        wins, starts = np.unique(win, return_index=True)
        bounds = np.append(starts, len(u))
        for k, w in enumerate(wins):
            s0, s1 = int(bounds[k]), int(bounds[k + 1])
            n = s1 - s0
            take_chunks = min(-(-n // W), nch - pos)
            take = min(n, take_chunks * W)
            dropped += n - take
            if take_chunks <= 0:
                continue
            r0 = pos * W
            uu[r0 : r0 + take] = u[s0 : s0 + take]
            vv[r0 : r0 + take] = v[s0 : s0 + take]
            mm[r0 : r0 + take] = True
            lu[r0 : r0 + take] = u[s0 : s0 + take] - int(w) * dst_stride
            wchunk[pos : pos + take_chunks] = w
            first[pos] = 1
            pos += take_chunks
    if pos == 0:
        first[0] = 1  # all padding: window 0 still gets temp
    else:
        wchunk[pos:] = wchunk[pos - 1]  # tail chunks: no-op revisits
    # Source-side inverse over the (holey) valid rows: padding keys to the
    # num_src drop sentinel, exactly like _pad_edges_sorted's tail padding.
    key = np.where(mm, vv, num_src)
    o2 = np.argsort(key, kind="stable").astype(np.int32)
    return (
        EdgeSet(
            u=uu,
            v=vv,
            mask=mm,
            inv_perm=o2,
            inv_dst=key[o2].astype(np.int32),
            win_lu=lu.reshape(-1, 1),
            win_chunk=wchunk,
            win_first=first,
            win_stride=int(dst_stride),
        ),
        dropped,
    )


def _threshold_edges(
    dst_ctrs: np.ndarray, src_ctrs: np.ndarray, th: float
) -> Tuple[np.ndarray, np.ndarray]:
    """All (i, j) with ||dst[i] - src[j]|| <= th (reference lanegcn.py:676-687)."""
    if len(dst_ctrs) == 0 or len(src_ctrs) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d = dst_ctrs[:, None, :] - src_ctrs[None, :, :]
    dist = np.sqrt((d ** 2).sum(2))
    return np.nonzero(dist <= th)[:2]


def precompute_fusion(scen: Dict, model_cfg: ModelConfig) -> Dict:
    """Per-scenario fusion edges (a2m/m2a/a2a within distance thresholds,
    reference lanegcn.py:672-689), local indices.

    These depend only on the scenario, not on pack composition, so they are
    computed once and memoized on the scenario dict (the preprocess CLI bakes
    them into shards). Re-derived if the thresholds change.
    """
    key = (
        model_cfg.actor2map_dist,
        model_cfg.map2actor_dist,
        model_cfg.actor2actor_dist,
    )
    cache = scen.get("_fusion")
    if cache is not None and cache["key"] == key:
        return cache
    g_ctrs, a_ctrs = scen["graph"]["ctrs"], scen["ctrs"]
    a2m = _threshold_edges(g_ctrs, a_ctrs, model_cfg.actor2map_dist)
    m2a = _threshold_edges(a_ctrs, g_ctrs, model_cfg.map2actor_dist)
    a2a = _threshold_edges(a_ctrs, a_ctrs, model_cfg.actor2actor_dist)
    cache = {
        "key": key,
        "a2m": (a2m[0].astype(np.int32), a2m[1].astype(np.int32)),
        "m2a": (m2a[0].astype(np.int32), m2a[1].astype(np.int32)),
        "a2a": (a2a[0].astype(np.int32), a2a[1].astype(np.int32)),
    }
    scen["_fusion"] = cache
    return cache


PACK_CACHE_VERSION = 3


def precompute_pack_cache(scen: Dict, model_cfg: ModelConfig) -> Dict:
    """Pack-ready per-scenario blobs, memoized on the scenario dict.

    Packing a 1024-scenario batch from raw dicts costs ~50 python-level
    list traversals over the scenarios; with the blobs it is ~6
    concatenations plus vectorized index arithmetic. The preprocess CLI
    bakes these into shards so training-time packing never recomputes them.

    Layout:
      actor_blob [na, 3*T_h + 2 + 2*T_p + T_p] f32 — feats‖ctrs‖gt‖has
      node_blob  [nn, 8] f32 — ctrs‖feats‖turn‖control‖intersect
      band_blob  [nn, 2*num_scales] bool — intra-lane band membership per
                 pre/suc relation (v = u + band_shift; offset-invariant,
                 so computed once here, not per pack)
      table_blob [nn, R] int32 — per-relation neighbor table: local source v
                 of the first non-banded edge per destination u, -1 when
                 none (left/right are functional by construction; pre/suc
                 residues have duplicates only at lane merges)
      edge_u/edge_v int32 — duplicate-destination overflow (edges whose u
                 already has a band/table entry for that relation), flat in
                 relation_names order; edge_counts [R] int64
      fus_u/fus_v int32 + fus_counts [3] (a2m, m2a, a2a)
      meta [6] f32 — rot.ravel()‖orig
    """
    key = (
        PACK_CACHE_VERSION,
        model_cfg.num_scales,
        model_cfg.num_hist,
        model_cfg.num_preds,
        model_cfg.actor2map_dist,
        model_cfg.map2actor_dist,
        model_cfg.actor2actor_dist,
    )
    cache = scen.get("_pack")
    if cache is not None and cache.get("key") == key:
        return cache
    g = scen["graph"]
    na = len(scen["feats"])
    nn = int(g["num_nodes"])
    actor_blob = np.concatenate(
        [
            np.asarray(scen["feats"], np.float32).reshape(na, -1),
            np.asarray(scen["ctrs"], np.float32),
            np.asarray(scen["gt_preds"], np.float32).reshape(na, -1),
            np.asarray(scen["has_preds"], np.float32),
        ],
        axis=1,
    )
    node_blob = np.concatenate(
        [
            np.asarray(g["ctrs"], np.float32),
            np.asarray(g["feats"], np.float32),
            np.asarray(g["turn"], np.float32).reshape(nn, 2),
            np.asarray(g["control"], np.float32).reshape(nn, 1),
            np.asarray(g["intersect"], np.float32).reshape(nn, 1),
        ],
        axis=1,
    )
    rel_names = relation_names(model_cfg.num_scales)
    us, vs, counts = [], [], []
    band_blob = np.zeros((nn, 2 * model_cfg.num_scales), bool)
    table_blob = np.full((nn, len(rel_names)), -1, np.int32)
    j = 0
    for r_idx, nm in enumerate(rel_names):
        if nm in ("left", "right"):
            e = g[nm]
        else:
            e = g[nm[:3]][int(nm[3:])]
        u = np.asarray(e["u"], np.int32)
        v = np.asarray(e["v"], np.int32)
        shift = band_shift(nm)
        if shift is not None:
            # At most one edge per (u, shift) pair exists (dilated adjacency
            # is deduplicated), so a bool mask over u is an exact encoding.
            banded = (v.astype(np.int64) - u) == shift
            band_blob[u[banded], j] = True
            j += 1
            u, v = u[~banded], v[~banded]
        if len(u):
            # Neighbor table: first remaining edge per destination; only
            # duplicate-destination edges (merges) stay in the flat list.
            _, first_idx = np.unique(u, return_index=True)
            first = np.zeros(len(u), bool)
            first[first_idx] = True
            table_blob[u[first], r_idx] = v[first]
            u, v = u[~first], v[~first]
        us.append(u)
        vs.append(v)
        counts.append(len(u))
    fus = precompute_fusion(scen, model_cfg)
    cache = {
        "key": key,
        "na": na,
        "nn": nn,
        "actor_blob": actor_blob,
        "node_blob": node_blob,
        "band_blob": band_blob,
        "table_blob": table_blob,
        "edge_u": np.concatenate(us) if us else np.zeros(0, np.int32),
        "edge_v": np.concatenate(vs) if vs else np.zeros(0, np.int32),
        "edge_counts": np.asarray(counts, np.int64),
        "fus_u": np.concatenate([fus[k][0] for k in ("a2m", "m2a", "a2a")]),
        "fus_v": np.concatenate([fus[k][1] for k in ("a2m", "m2a", "a2a")]),
        "fus_counts": np.asarray(
            [len(fus[k][0]) for k in ("a2m", "m2a", "a2a")], np.int64
        ),
        "meta": np.concatenate(
            [np.asarray(scen["rot"], np.float32).ravel(), np.asarray(scen["orig"], np.float32)]
        ),
    }
    scen["_pack"] = cache
    return cache


def _split_first_per_destination(
    u: np.ndarray, v: np.ndarray, n_cap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First edge per destination → [n_cap] neighbor table (sentinel n_cap);
    returns (table, residual_u, residual_v)."""
    tbl = np.full(n_cap, n_cap, np.int32)
    if len(u):
        _, first_idx = np.unique(u, return_index=True)
        first = np.zeros(len(u), bool)
        first[first_idx] = True
        tbl[np.asarray(u)[first].astype(np.int64)] = np.asarray(v)[first]
        u, v = np.asarray(u)[~first], np.asarray(v)[~first]
    return tbl, u, v


def _build_table_inverse(
    tables: Dict[str, np.ndarray],
    names: Sequence[str],
    n_cap: int,
    cap: int,
    pend: Dict[str, Tuple[np.ndarray, np.ndarray]],
    stats: Dict[str, int],
) -> EdgeSet:
    """Combined inverse of the neighbor tables (for the table-gather
    backward): (flat cotangent row stack_row*N + u, stack rows in `names`
    order over the TABLED relations) → tabled source v, sorted by v. If it
    overflows capacity, demote the tail's table entries back to the regular
    edge lists (`pend`, mutated) so (tables, inverse) stay exactly
    consistent."""
    tabled_names = [nm for nm in names if nm in tables]
    srcs, dsts = [], []
    for r, nm in enumerate(tabled_names):
        tbl = tables[nm]
        uu = np.nonzero(tbl < n_cap)[0]
        srcs.append(r * n_cap + uu.astype(np.int64))
        dsts.append(tbl[uu].astype(np.int64))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if len(src) > cap:
        stats["demoted_table_edges"] = int(len(src) - cap)
        for flat, vv in zip(src[cap:], dst[cap:]):
            r, uu = int(flat) // n_cap, int(flat) % n_cap
            nm = tabled_names[r]
            tables[nm][uu] = n_cap
            stats[f"tabled_{nm}"] -= 1
            pu, pv = pend[nm]
            pend[nm] = (np.append(pu, uu), np.append(pv, vv))
        src, dst = src[:cap], dst[:cap]
    iu = np.full(cap, max(len(tabled_names), 1) * n_cap, np.int32)
    iv = np.full(cap, n_cap, np.int32)
    im = np.zeros(cap, bool)
    iu[: len(src)] = src
    iv[: len(dst)] = dst
    im[: len(src)] = True
    return EdgeSet(u=iu, v=iv, mask=im)


def _segment_reorder(
    flat: np.ndarray, counts: np.ndarray, seg_add: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Scenario-major → relation-major reorder of concatenated segments.

    flat: concat over scenarios of per-scenario relation-ordered segments;
    counts, seg_add: [S, R] per-(scenario, relation) lengths / index offsets.
    Returns (relation-major values + offsets, per-relation totals).
    """
    S, R = counts.shape
    cflat = counts.reshape(-1)
    E = int(flat.shape[0])
    src_start = np.zeros(S * R, np.int64)
    np.cumsum(cflat[:-1], out=src_start[1:])
    per_rel = counts.sum(axis=0)
    rel_off = np.zeros(R, np.int64)
    np.cumsum(per_rel[:-1], out=rel_off[1:])
    within = np.zeros((S, R), np.int64)
    np.cumsum(counts[:-1], axis=0, out=within[1:])
    dest_start = (rel_off[None, :] + within).reshape(-1)
    idx = np.arange(E, dtype=np.int64) + np.repeat(dest_start - src_start, cflat)
    out = np.empty(E, np.int64)
    out[idx] = flat.astype(np.int64, copy=False) + np.repeat(
        seg_add.reshape(-1), cflat
    )
    return out, per_rel




def window_place(n_off: int, size: int, stride: int | None) -> int:
    """First-fit window-aligned placement: return the start row for a block
    of `size` rows given the current fill `n_off`. Blocks that fit inside
    the current stride-window's remainder stay contiguous; otherwise they
    start at the next window boundary (oversize blocks straddle)."""
    if stride is None or size > stride:
        return n_off
    room = stride - (n_off % stride)
    return n_off + room if size > room else n_off


class WindowBinPacker:
    """First-fit bin packing of small blocks into stride-row windows.

    Unlike window_place (which only looks at the current tail), items may
    land in ANY window with room, so ~70-row RoIs fill 256-row windows to
    ~97% instead of leaving first-fit tails (~20% waste measured). Oversize
    items (> stride) consume a run of empty windows. Placement is stateful:
    use try_place per item group and roll back by restoring fills."""

    def __init__(self, stride: int, num_windows: int):
        self.stride = stride
        self.fills = np.zeros(num_windows, np.int64)

    def try_place(self, sizes) -> list | None:
        """Place each size; returns start rows, or None (state restored) if
        any item does not fit."""
        snapshot = self.fills.copy()
        starts = []
        for size in sizes:
            size = int(size)
            if size <= self.stride:
                ok = np.nonzero(self.fills + size <= self.stride)[0]
                if not len(ok):
                    self.fills = snapshot
                    return None
                w = int(ok[0])
                starts.append(w * self.stride + int(self.fills[w]))
                self.fills[w] += size
            else:
                # oversize: a run of ceil(size/stride) fully-empty windows
                k = -(-size // self.stride)
                empty = self.fills == 0
                run = 0
                w0 = -1
                for w in range(len(empty)):
                    run = run + 1 if empty[w] else 0
                    if run == k:
                        w0 = w - k + 1
                        break
                if w0 < 0:
                    self.fills = snapshot
                    return None
                starts.append(w0 * self.stride)
                self.fills[w0 : w0 + k - 1] = self.stride
                self.fills[w0 + k - 1] = size - (k - 1) * self.stride
        return starts


def build_window_plan(
    pend: Dict[str, Tuple[np.ndarray, np.ndarray]],
    names: Sequence[str],
    stride: int,
    n_windows: int,
    plan_cap: int,
    stats: Dict,
):
    """Window edge plan for ops/pallas_scenario_agg: edges whose endpoints
    share one stride-window become per-window local (dst, src, relation)
    triples; cross-window edges and per-window budget overflow stay in the
    classic lists (pend is mutated to hold only the residue).

    Round-5 layout: slots are GROUP-ALIGNED — each window holds the
    left/right edges first, padded to a 512-slot chunk multiple, then the
    dilated relations. Chunks are then relation-group-pure and the kernel
    runs only the group's relation matmuls (scenario_aggregate(groups=...)
    — the alignment is that kernel's correctness invariant). Functional /
    cheap relations are admitted first so budget overflow lands on the
    high-dilation scales. Returns (plan_lu, plan_lv, plan_rel) as
    [n_windows*plan_cap, 1] int32."""
    from lanegcn_tpu_torch.ops.scenario_agg import _CHUNK, GROUPED_MIN_CAP

    num_rel = len(names)
    chunk = _CHUNK
    plan_lu = np.full((n_windows * plan_cap, 1), -1, np.int32)
    plan_lv = np.full((n_windows * plan_cap, 1), -1, np.int32)
    plan_rel = np.full((n_windows * plan_cap, 1), -1, np.int32)
    key = lambda r: names[r][3:]
    if plan_cap >= GROUPED_MIN_CAP:
        groups = [
            sorted((r for r in range(num_rel) if names[r] in ("left", "right")), key=key),
            sorted((r for r in range(num_rel) if names[r] not in ("left", "right")), key=key),
        ]
        groups = [g for g in groups if g]
    else:
        # Too small for chunk-aligned group runs: single-group layout
        # (functional relations still admitted first).
        groups = [sorted(range(num_rel), key=lambda r: (
            0 if names[r] in ("left", "right") else 1, names[r][3:]))]
    stats["plan_edges"] = 0
    stats["spilled_plan_edges"] = 0
    stats["plan_align_pad"] = 0
    offsets = np.zeros(n_windows, np.int64)  # next free slot per window
    spills: list = []
    for gi, grp in enumerate(groups):
        all_u = np.concatenate([pend[names[r]][0] for r in grp]).astype(np.int64)
        all_v = np.concatenate([pend[names[r]][1] for r in grp]).astype(np.int64)
        all_r = np.repeat(
            np.asarray(grp, np.int32), [len(pend[names[r]][0]) for r in grp]
        )
        if not len(all_u):
            continue
        w_u = all_u // stride
        in_win = w_u == (all_v // stride)
        iw = np.nonzero(in_win)[0]
        order = iw[np.argsort(w_u[iw], kind="stable")]
        w_sorted = w_u[order]
        cnt = np.bincount(w_sorted, minlength=n_windows)
        starts = np.zeros(n_windows, np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        pos = np.arange(len(order), dtype=np.int64) - np.repeat(starts, cnt)
        base = offsets[w_sorted]
        fit = base + pos < plan_cap
        sel = order[fit]
        slots = (w_sorted * plan_cap + base + pos)[fit]
        plan_lu[slots, 0] = all_u[sel] % stride
        plan_lv[slots, 0] = all_v[sel] % stride
        plan_rel[slots, 0] = all_r[sel]
        keep = np.zeros(len(all_u), bool)
        keep[sel] = True
        stats["plan_edges"] += int(keep.sum())
        stats["spilled_plan_edges"] += int((~keep).sum())
        spills.append((all_u[~keep], all_v[~keep], all_r[~keep]))
        used = offsets + np.bincount(w_sorted[fit], minlength=n_windows)
        if gi + 1 < len(groups):
            # Chunk-align the next group's start (the kernel's invariant).
            aligned = np.minimum(-(-used // chunk) * chunk, plan_cap)
            stats["plan_align_pad"] += int((aligned - used).sum())
            offsets = aligned
        else:
            offsets = used
    if spills:
        su = np.concatenate([s[0] for s in spills])
        sv = np.concatenate([s[1] for s in spills])
        sr = np.concatenate([s[2] for s in spills])
    else:
        su = sv = np.zeros(0, np.int64)
        sr = np.zeros(0, np.int32)
    for r2, nm in enumerate(names):
        m = sr == r2
        pend[nm] = (su[m], sv[m])
    return plan_lu, plan_lv, plan_rel


def build_pair_plan(
    u: np.ndarray,
    v: np.ndarray,
    dst_stride: int,
    src_stride: int,
    capacity: int,
    chunk: int,
    rel: np.ndarray | None = None,
    return_residue: bool = False,
):
    """Window-pair chunked edge layout for ops/pallas_win_edge.

    Groups edges by (destination window, source window) pair, sorts groups
    by (dwin, swin), and lays each group out in chunk-aligned slots so every
    chunk's edges share ONE window pair (the kernel's locality unit; local
    indices are u % dst_stride / v % src_stride). Also emits the chunk
    permutation sorted by (swin, dwin) for the backward's source-side pass.
    Edges past `capacity // chunk` chunks are dropped (returned count).
    """
    nc = max(capacity // chunk, 1)
    lu = np.full((nc * chunk, 1), -1, np.int32)
    lv = np.full((nc * chunk, 1), -1, np.int32)
    lr_rel = None if rel is None else np.full((nc * chunk, 1), -1, np.int32)
    res = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int32))
    dwin_c = np.zeros(nc, np.int32)
    swin_c = np.zeros(nc, np.int32)
    first_c = np.zeros(nc, np.int32)
    dropped = 0
    used = 0
    if len(u):
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        dw = u // dst_stride
        sw = v // src_stride
        order = np.lexsort((sw, dw))
        dw_s, sw_s = dw[order], sw[order]
        key = dw_s << np.int64(31) | sw_s
        newgrp = np.ones(len(order), bool)
        newgrp[1:] = key[1:] != key[:-1]
        grp_id = np.cumsum(newgrp) - 1
        grp_start = np.nonzero(newgrp)[0]
        grp_cnt = np.diff(np.append(grp_start, len(order)))
        g_chunks = -(-grp_cnt // chunk)
        g_chunk_start = np.concatenate([[0], np.cumsum(g_chunks)])
        pos_in_grp = np.arange(len(order), dtype=np.int64) - grp_start[grp_id]
        chunk_of_edge = g_chunk_start[grp_id] + pos_in_grp // chunk
        fit = chunk_of_edge < nc
        dropped = int((~fit).sum())
        sel = order[fit]
        slots = (chunk_of_edge * chunk + pos_in_grp % chunk)[fit]
        lu[slots, 0] = u[sel] % dst_stride
        lv[slots, 0] = v[sel] % src_stride
        if rel is not None:
            lr_rel[slots, 0] = np.asarray(rel)[sel]
        if return_residue:
            drop_sel = order[~fit]
            res = (
                u[drop_sel], v[drop_sel],
                (np.asarray(rel)[drop_sel] if rel is not None
                 else np.zeros(len(drop_sel), np.int32)),
            )
        used = min(int(g_chunk_start[-1]), nc)
        if used:
            ch_ids = np.arange(used)
            g_of_chunk = np.searchsorted(g_chunk_start, ch_ids, side="right") - 1
            dwin_c[:used] = dw_s[grp_start[g_of_chunk]]
            swin_c[:used] = sw_s[grp_start[g_of_chunk]]
            first_c[0] = 1
            first_c[1:used] = dwin_c[1:used] != dwin_c[: used - 1]
            # Inactive tail chunks ride the last active destination window
            # (their one-hot rows are all zero, so they accumulate nothing);
            # keeping the index consecutive avoids a block revisit.
            dwin_c[used:] = dwin_c[used - 1]
            swin_c[used:] = swin_c[used - 1]
    if used == 0:
        # Degenerate plan: chunk 0 must still initialize block 0 (the fwd
        # writes temp, the bwd writes zeros) — all other blocks keep their
        # aliased inputs.
        first_c[0] = 1
    # Source-side order: active chunks sorted by (swin, dwin), inactive last
    # (they point at the final active swin, consecutive with its run).
    act = np.arange(nc) < max(used, 1)
    sperm = np.concatenate([
        np.lexsort((dwin_c[:max(used, 1)], swin_c[:max(used, 1)])),
        np.arange(max(used, 1), nc),
    ]).astype(np.int32)
    sswin = swin_c[sperm].copy()
    if used:
        sswin[used:] = sswin[used - 1]
    sfirst = np.zeros(nc, np.int32)
    sfirst[0] = 1
    if nc > 1:
        sfirst[1:max(used, 1)] = (
            sswin[1:max(used, 1)] != sswin[: max(used, 1) - 1]
        )
    del act
    plan = {
        "lu": lu,
        "lv": lv,
        "dwin": dwin_c,
        "swin": swin_c,
        "first": first_c,
        "sperm": sperm,
        "sswin": sswin,
        "sfirst": sfirst,
    }
    if lr_rel is not None:
        plan["rel"] = lr_rel
    if return_residue:
        return plan, dropped, res
    return plan, dropped


def pack_batch(
    scenarios: Sequence[Dict],
    pack_cfg: PackConfig,
    model_cfg: ModelConfig,
    split_bands: bool = True,
    split_tables: bool = True,
    table_relations: Tuple[str, ...] | None = None,
    scenario_plan: bool = True,
) -> Tuple[PackedBatch, Dict[str, int]]:
    """Pack up to pack_cfg.max_scenarios scenarios; returns (batch, stats).

    Scenarios that would overflow actor/node capacity are skipped (counted in
    stats["skipped_scenarios"]); overflowing edge lists are truncated with
    per-relation drop counts.

    split_bands: route each pre/suc relation's intra-lane edges
    (v = u + band_shift(nm); lanes are contiguous node runs, offsets
    preserved by packing) into a per-node [N] bool band mask instead of the
    edge list. The model applies bands as a masked roll — no gather/scatter —
    and the edge lists keep only the irregular (cross-lane) remainder.

    split_tables: route the first edge per (destination, relation) of each
    relation in `table_relations` into a per-node [N] int32 neighbor table
    (value = pack-global source row, or max_nodes ⇒ none). left/right are
    functional (nearest-node matching, reference preprocess_data.py:332-334),
    so tables absorb them entirely and the scatter-add shrinks to the
    (near-empty) duplicate-destination overflow lists. Tabling is restricted
    to left/right by default: XLA row-gathers run ~100 GB/s on this chip, so
    gathering mostly-invalid table rows for the 12 banded pre/suc relations
    costs more than scattering their small cross-lane residue lists
    (measured: the [14, N] stacked gather was 3.96 ms/layer forward vs
    0.6 ms for [2, N]).

    The hot path is fully vectorized: per-scenario work is limited to
    acceptance checks and list collection; all index arithmetic happens on
    concatenated arrays (np.repeat of per-scenario offsets), and fusion
    threshold edges come precomputed from `precompute_fusion`.

    scenario_plan: with pack_cfg.node_stride + max_plan_edges set, lay nodes
    out STRIDED (scenario s owns rows [s*stride, (s+1)*stride)) and emit the
    scenario edge plan for ops/pallas_scenario_agg — per-scenario local
    (dst, src, relation) triples covering the overflow edges, with the
    residue past each scenario's budget spilled back to the classic lists.
    """
    names = relation_names(model_cfg.num_scales)
    if table_relations is None:
        table_relations = pack_cfg.table_relations
    if not table_relations:
        split_tables = False
    b_cap = pack_cfg.max_scenarios
    a_cap, n_cap = pack_cfg.max_actors, pack_cfg.max_nodes
    stride = pack_cfg.node_stride
    if stride is not None:
        assert n_cap % stride == 0, (
            f"windowed layout requires max_nodes ({n_cap}) to be a "
            f"multiple of node_stride ({stride})"
        )
    astride = pack_cfg.actor_stride
    if astride is not None:
        assert a_cap % astride == 0, (
            f"windowed actor layout requires max_actors ({a_cap}) to be a "
            f"multiple of actor_stride ({astride})"
        )
    fusion_pairs = bool(
        pack_cfg.fusion_pairs and stride is not None and astride is not None
    )
    plan_cap = pack_cfg.max_plan_edges if (scenario_plan and stride) else 0
    n_windows = (n_cap // stride) if stride else 0
    t_hist, t_pred = model_cfg.num_hist, model_cfg.num_preds

    stats = {"skipped_scenarios": 0, "packed_scenarios": 0}
    # Submission identity of accepted scenarios, in packed order (reference
    # attaches argo_id/city per scenario, data.py:364-434, test.py:110-113).
    stats["seq_ids"] = []
    stats["cities"] = []

    # --- acceptance pass: pick scenarios that fit, assign offsets ---
    # With node_stride: window-aligned first-fit — a scenario is placed in
    # the current stride-window's remainder when it fits, else at the next
    # window boundary, so most scenarios live inside ONE window (the
    # scenario-plan kernel's locality unit) while density stays ~contiguous.
    # Oversize scenarios (> stride nodes) still pack — they just straddle,
    # and their cross-window edges spill to the classic lists.
    accepted: List[Dict] = []
    na_list: List[int] = []
    nn_list: List[int] = []
    start_list: List[int] = []
    a_start_list: List[int] = []
    a_off = n_off = 0
    for scen in scenarios:
        if len(accepted) >= b_cap:
            stats["skipped_scenarios"] += 1
            continue
        cache = precompute_pack_cache(scen, model_cfg)
        na, nn = cache["na"], cache["nn"]
        start = window_place(n_off, nn, stride)
        a_start = window_place(a_off, na, astride)
        if na == 0 or a_start + na > a_cap or start + nn > n_cap:
            stats["skipped_scenarios"] += 1
            continue
        stats["seq_ids"].append(int(scen.get("seq_id", len(accepted))))
        stats["cities"].append(str(scen.get("city", "")))
        accepted.append(cache)
        na_list.append(na)
        nn_list.append(nn)
        start_list.append(start)
        a_start_list.append(a_start)
        a_off = a_start + na
        n_off = start + nn
    si = len(accepted)
    stats["packed_scenarios"] = si
    stats["num_actors"] = a_off
    stats["num_nodes"] = n_off
    na_arr = np.asarray(na_list, np.int64)
    nn_arr = np.asarray(nn_list, np.int64)
    a_offs = np.asarray(a_start_list, np.int64)
    n_offs = np.asarray(start_list, np.int64)

    # --- vectorized assembly ---
    actor_feats = np.zeros((a_cap, t_hist, 3), np.float32)
    actor_ctrs = np.zeros((a_cap, 2), np.float32)
    actor_mask = np.zeros(a_cap, bool)
    actor_scen = np.zeros(a_cap, np.int32)
    gt_preds = np.zeros((a_cap, t_pred, 2), np.float32)
    has_preds = np.zeros((a_cap, t_pred), bool)

    node_ctrs = np.zeros((n_cap, 2), np.float32)
    node_feats = np.zeros((n_cap, 2), np.float32)
    node_turn = np.zeros((n_cap, 2), np.float32)
    node_control = np.zeros(n_cap, np.float32)
    node_intersect = np.zeros(n_cap, np.float32)
    node_mask = np.zeros(n_cap, bool)
    node_scen = np.zeros(n_cap, np.int32)

    rot = np.tile(np.eye(2, dtype=np.float32), (b_cap, 1, 1))
    orig = np.zeros((b_cap, 2), np.float32)
    scen_mask = np.zeros(b_cap, bool)
    agent_idx = np.zeros(b_cap, np.int32)

    num_rel = len(names)
    t_a = 3 * t_hist  # actor_blob column boundaries
    if si:
        A, N = int(na_arr.sum()), int(nn_arr.sum())  # concatenated rows (the
        # packed spans a_off/n_off additionally count window-alignment gaps)
        ablob = np.concatenate([c["actor_blob"] for c in accepted])
        # Destination row per concatenated actor: contiguous, or strided by
        # scenario (actor_stride layout — mirrors the node windows below).
        contig_a = np.zeros(si, np.int64)
        np.cumsum(na_arr[:-1], out=contig_a[1:])
        a_rows = np.repeat(a_offs, na_arr) + (
            np.arange(A, dtype=np.int64) - np.repeat(contig_a, na_arr)
        )
        actor_feats[a_rows] = ablob[:, :t_a].reshape(A, t_hist, 3)
        actor_ctrs[a_rows] = ablob[:, t_a : t_a + 2]
        actor_mask[a_rows] = True
        actor_scen[a_rows] = np.repeat(np.arange(si, dtype=np.int32), na_arr)
        gt_preds[a_rows] = ablob[:, t_a + 2 : t_a + 2 + 2 * t_pred].reshape(A, t_pred, 2)
        has_preds[a_rows] = ablob[:, t_a + 2 + 2 * t_pred :] > 0.5

        nblob = np.concatenate([c["node_blob"] for c in accepted])
        # Destination row per concatenated node: contiguous, or strided by
        # scenario (node_stride layout).
        contig_starts = np.zeros(si, np.int64)
        np.cumsum(nn_arr[:-1], out=contig_starts[1:])
        node_add = np.repeat(n_offs, nn_arr)  # [N] pack-global offset per row
        dst_rows = node_add + (np.arange(N, dtype=np.int64) - np.repeat(contig_starts, nn_arr))
        node_ctrs[dst_rows] = nblob[:, 0:2]
        node_feats[dst_rows] = nblob[:, 2:4]
        node_turn[dst_rows] = nblob[:, 4:6]
        node_control[dst_rows] = nblob[:, 6]
        node_intersect[dst_rows] = nblob[:, 7]
        node_mask[dst_rows] = True
        node_scen[dst_rows] = np.repeat(np.arange(si, dtype=np.int32), nn_arr)

        meta = np.stack([c["meta"] for c in accepted])
        rot[:si] = meta[:, :4].reshape(si, 2, 2)
        orig[:si] = meta[:, 4:6]
        scen_mask[:si] = True
        agent_idx[:si] = a_offs  # AGENT is actor 0 of its scenario

        # LaneConv edges: scenario-major flat → relation-major, node offsets.
        # Intra-lane bands were already split off in the cache, so this flat
        # list holds only the cross-lane residue + left/right.
        e_counts = np.stack([c["edge_counts"] for c in accepted])  # [S, R]
        n_add = np.broadcast_to(n_offs[:, None], (si, num_rel))
        rel_u, per_rel = _segment_reorder(
            np.concatenate([c["edge_u"] for c in accepted]), e_counts, n_add
        )
        rel_v, _ = _segment_reorder(
            np.concatenate([c["edge_v"] for c in accepted]), e_counts, n_add
        )
        band_cat = np.concatenate([c["band_blob"] for c in accepted])  # [N, 2S]
        table_cat = np.concatenate([c["table_blob"] for c in accepted])  # [N, R]
        # Fusion edges: u/v offset bases differ per relation (a2m, m2a, a2a).
        f_counts = np.stack([c["fus_counts"] for c in accepted])  # [S, 3]
        fu_add = np.stack([n_offs, a_offs, a_offs], axis=1)
        fv_add = np.stack([a_offs, n_offs, a_offs], axis=1)
        fus_u, per_fus = _segment_reorder(
            np.concatenate([c["fus_u"] for c in accepted]), f_counts, fu_add
        )
        fus_v, _ = _segment_reorder(
            np.concatenate([c["fus_v"] for c in accepted]), f_counts, fv_add
        )
    else:
        rel_u = rel_v = fus_u = fus_v = np.zeros(0, np.int64)
        per_rel = np.zeros(num_rel, np.int64)
        per_fus = np.zeros(3, np.int64)
        band_cat = np.zeros((0, 2 * model_cfg.num_scales), bool)
        table_cat = np.zeros((0, num_rel), np.int32)
        node_add = np.zeros(0, np.int64)
        dst_rows = np.zeros(0, np.int64)

    bands = {} if split_bands else None
    tables = {} if split_tables else None
    pend: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    off = 0
    j = 0
    for r, nm in enumerate(names):
        u = rel_u[off : off + per_rel[r]]
        v = rel_v[off : off + per_rel[r]]
        off += per_rel[r]
        shift = band_shift(nm)
        if shift is not None:
            col = band_cat[:, j]
            j += 1
            if split_bands:
                mask = np.zeros(n_cap, bool)
                mask[dst_rows] = col
                bands[nm] = mask
                stats[f"banded_{nm}"] = int(col.sum())
            else:
                # Reconstruct the full edge list (band edges stay within one
                # scenario: v = u + shift along a contiguous lane run).
                bu = dst_rows[col]
                u = np.concatenate([u, bu])
                v = np.concatenate([v, bu + shift])
        tcol = table_cat[:, r]
        tvalid = tcol >= 0
        if split_tables and nm in table_relations:
            tbl = np.full(n_cap, n_cap, np.int32)
            tbl[dst_rows[tvalid]] = tcol[tvalid] + node_add[tvalid]
            tables[nm] = tbl
            stats[f"tabled_{nm}"] = int(tvalid.sum())
        else:
            # Reconstruct table edges into the flat list (u = packed row).
            u = np.concatenate([u, dst_rows[tvalid]])
            v = np.concatenate([v, tcol[tvalid] + node_add[tvalid]])
        pend[nm] = (u, v)

    table_inv = None
    if split_tables:
        table_inv = _build_table_inverse(
            tables, names, n_cap, pack_cfg.table_edge_capacity, pend, stats
        )

    # Window edge plan: overflow edges whose endpoints share one
    # stride-window become per-window local (dst, src, relation) triples for
    # ops/pallas_scenario_agg; cross-window edges and the residue past a
    # window's budget stay in the classic lists.
    plan_lu = plan_lv = plan_rel = None
    spill_pair = None
    if plan_cap:
        plan_lu, plan_lv, plan_rel = build_window_plan(
            pend, names, stride, n_windows, plan_cap, stats
        )
        if pack_cfg.spill_pairs:
            # The window plan's residue rides a (dst-window, src-window)
            # chunk-pair plan (ops/pallas_pair_agg); the classic lists keep
            # only what overflows the pair capacity.
            su = np.concatenate([pend[nm][0] for nm in names])
            sv = np.concatenate([pend[nm][1] for nm in names])
            sr = np.repeat(
                np.arange(len(names), dtype=np.int32),
                [len(pend[nm][0]) for nm in names],
            )
            plan_d, sp_dropped, (ru, rv, rr) = build_pair_plan(
                su, sv, stride, stride, pack_cfg.max_spill_pair_edges,
                pack_cfg.pair_chunk, rel=sr, return_residue=True,
            )
            stats["spill_pair_edges"] = int(len(su)) - sp_dropped
            for r2, nm in enumerate(names):
                m = rr == r2
                pend[nm] = (ru[m], rv[m])
            spill_pair = PairPlan(
                idx=np.concatenate(
                    [plan_d["lu"], plan_d["lv"], plan_d["rel"]], axis=1
                ),
                meta=np.stack([
                    plan_d["dwin"], plan_d["swin"], plan_d["first"],
                    plan_d["sperm"], plan_d["sswin"], plan_d["sfirst"],
                ]),
                chunk=pack_cfg.pair_chunk,
                dst_stride=stride,
                src_stride=stride,
            )

    edges = {}
    for nm in names:
        u, v = pend[nm]
        edges[nm], dropped = _pad_edges(u, v, pack_cfg.edge_capacity(nm))
        stats[f"dropped_{nm}"] = dropped

    def _fuse(u, v, cap, name, num_src):
        es, dropped = _pad_edges_sorted(u, v, cap, num_src)
        stats[f"dropped_{name}"] = dropped
        return es

    f_off = np.zeros(4, np.int64)
    np.cumsum(per_fus, out=f_off[1:])

    def _pair(u, v, d_stride, s_stride, cap, name):
        plan, dropped = build_pair_plan(
            u, v, d_stride, s_stride, cap, pack_cfg.pair_chunk
        )
        stats[f"dropped_pair_{name}"] = dropped
        return PairPlan(
            idx=np.concatenate([plan["lu"], plan["lv"]], axis=1),
            meta=np.stack([
                plan["dwin"], plan["swin"], plan["first"],
                plan["sperm"], plan["sswin"], plan["sfirst"],
            ]),
            chunk=pack_cfg.pair_chunk,
            dst_stride=d_stride,
            src_stride=s_stride,
        )

    pair_a2m = pair_m2a = pair_a2a = None
    if fusion_pairs:
        pair_a2m = _pair(
            fus_u[: f_off[1]], fus_v[: f_off[1]], stride, astride,
            pack_cfg.max_a2m_edges, "a2m",
        )
        pair_m2a = _pair(
            fus_u[f_off[1] : f_off[2]], fus_v[f_off[1] : f_off[2]],
            astride, stride, pack_cfg.max_m2a_edges, "m2a",
        )
        pair_a2a = _pair(
            fus_u[f_off[2] : f_off[3]], fus_v[f_off[2] : f_off[3]],
            astride, astride, pack_cfg.max_a2a_edges, "a2a",
        )
    if fusion_pairs:
        # The pair plans carry ALL fusion edges (pairs are arbitrary window
        # combinations, so nothing spills); the EdgeSets would be dead
        # weight in the transfer — emit minimal shells.
        z = np.zeros(0, np.int64)
        fusion = FusionEdges(
            a2m=_pad_edges(z, z, 8)[0],
            m2a=_pad_edges(z, z, 8)[0],
            a2a=_pad_edges(z, z, 8)[0],
            pair_a2m=pair_a2m,
            pair_m2a=pair_m2a,
            pair_a2a=pair_a2a,
        )
    else:
        fusion = FusionEdges(
            a2m=_fuse(
                fus_u[: f_off[1]], fus_v[: f_off[1]], pack_cfg.max_a2m_edges,
                "a2m", a_cap,
            ),
            m2a=_fuse(
                fus_u[f_off[1] : f_off[2]], fus_v[f_off[1] : f_off[2]],
                pack_cfg.max_m2a_edges, "m2a", n_cap,
            ),
            a2a=_fuse(
                fus_u[f_off[2] : f_off[3]], fus_v[f_off[2] : f_off[3]],
                pack_cfg.max_a2a_edges, "a2a", a_cap,
            ),
        )

    batch = PackedBatch(
        actors=ActorBatch(feats=actor_feats, ctrs=actor_ctrs, mask=actor_mask, scen=actor_scen),
        graph=LaneGraphBatch(
            ctrs=node_ctrs,
            feats=node_feats,
            turn=node_turn,
            control=node_control,
            intersect=node_intersect,
            node_mask=node_mask,
            node_scen=node_scen,
            edges=edges,
            bands=bands,
            tables=tables,
            table_inv=table_inv,
            plan_lu=plan_lu,
            plan_lv=plan_lv,
            plan_rel=plan_rel,
            plan_scen=n_windows if plan_cap else 0,
            spill_pair=spill_pair,
        ),
        fusion=fusion,
        gt_preds=gt_preds,
        has_preds=has_preds,
        rot=rot,
        orig=orig,
        scen_mask=scen_mask,
        agent_idx=agent_idx,
    )
    return batch, stats
