"""Pack LaneRCNN RoI scenarios into static-shape RoiPackedBatch packs.

Host-side equivalent of the reference's subgraph_gather + the on-GPU
LanePooling edge construction (reference lanercnn.py:122-231, 474-489):
RoIs are flattened RoI-major with pack-global node indices; the pooling
edges (RoI-node ↔ global-node ≤6 m, traj-point ↔ interest-node ≤6 m) are
precomputed exactly from data-time centers.

Like pack_batch, everything pack-composition-invariant (subgraph node
blobs, band splits, pooling threshold edges, focal-agent features) is
precomputed once per scenario (`precompute_roi_cache`, memoized on the
scenario dict), so packing is vectorized concatenation plus per-scenario
offset arithmetic. The port's copy of the JAX package's RoI packer: the
same arrays, array for array, with numpy leaves (`RoiPackedBatch.from_numpy`
turns them into tensors).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from lanegcn_tpu_torch.config import (
    ModelConfig,
    PackConfig,
    RoiPackConfig,
    band_shift,
    relation_names,
)
from lanegcn_tpu_torch.data.packing import (
    WCHUNK,
    WindowBinPacker,
    _build_table_inverse,
    _pad_edges,
    _pad_edges_sorted,
    _split_first_per_destination,
    _segment_reorder,
    _threshold_edges,
    pack_batch,
    build_window_plan,
    window_chunked_edges,
    window_place,
)
from lanegcn_tpu_torch.graph import RoiPackedBatch

ROI_CACHE_VERSION = 1


def precompute_roi_cache(
    scen: Dict, model_cfg: ModelConfig, pooling_dist: float = 6.0
) -> Dict:
    """Pack-ready RoI blobs for one scenario, scenario-local index spaces.

    Scenario must carry "subgraphs"/"valid_agent_ids" (lane_roi.py) plus the
    base featurization + graph. Layouts (S subs, M = Σ sub nodes, T = hist,
    Tp = pred):
      rnode_blob [M, 8], rband_blob [M, 2*num_scales] bool
      redge_u/redge_v int32 + redge_counts [R] — cross-lane residue +
        left/right, relation-major within the scenario
      agent_feat [S, 4T], agent_vel [S], sub_counts [S]
      a2m_u (RoI row, scenario-local) / a2m_v (RoI-node row)
      pool_ru (RoI-node row) / pool_gv (global-node row) — ≤ pooling_dist
      a2r_u (interest-node row 0..int_nn) / a2r_v (traj step 0..T)
      meta [2+2+1+2T+2T+2Tp+Tp] — focal ctr‖dir‖vel‖trajs‖traj_dirs‖gt‖has
    """
    key = (ROI_CACHE_VERSION, model_cfg.num_scales, model_cfg.num_hist,
           model_cfg.num_preds, pooling_dist)
    cache = scen.get("_roi_pack")
    if cache is not None and cache.get("key") == key:
        return cache

    t_hist = model_cfg.num_hist
    names = relation_names(model_cfg.num_scales)
    subs = scen.get("subgraphs", [])
    valid_ids = scen.get("valid_agent_ids", np.zeros(0, np.int64))
    g_ctrs = scen["graph"]["ctrs"]
    num_subs = len(subs)
    sub_counts = np.asarray([s["num_nodes"] for s in subs], np.int64)
    tot = int(sub_counts.sum())

    rnode_blob = (
        np.concatenate([np.asarray(s["feats"], np.float32) for s in subs])
        if subs
        else np.zeros((0, 8), np.float32)
    )
    m_offs = np.zeros(num_subs, np.int64)
    if num_subs:
        np.cumsum(sub_counts[:-1], out=m_offs[1:])

    # Edges: per relation, concat subs with scenario-local offsets; band split.
    rband_blob = np.zeros((tot, 2 * model_cfg.num_scales), bool)
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    counts: List[int] = []
    j = 0
    for nm in names:
        parts_u, parts_v = [], []
        for k, sub in enumerate(subs):
            e = sub[nm] if nm in ("left", "right") else sub[nm[:3]][int(nm[3:])]
            parts_u.append(np.asarray(e["u"], np.int64) + m_offs[k])
            parts_v.append(np.asarray(e["v"], np.int64) + m_offs[k])
        u = np.concatenate(parts_u) if parts_u else np.zeros(0, np.int64)
        v = np.concatenate(parts_v) if parts_v else np.zeros(0, np.int64)
        shift = band_shift(nm)
        if shift is not None:
            banded = (v - u) == shift
            rband_blob[u[banded], j] = True
            j += 1
            u, v = u[~banded], v[~banded]
        us.append(u.astype(np.int32))
        vs.append(v.astype(np.int32))
        counts.append(len(u))

    # a2m: agent feature → its RoI's nodes within 5 m (precomputed in the
    # subgraph); u = RoI row (scenario-local), v = RoI-node row.
    a2m_u = np.concatenate(
        [np.full(len(s["a2m"]["v"]), k, np.int32) for k, s in enumerate(subs)]
    ) if subs else np.zeros(0, np.int32)
    a2m_v = np.concatenate(
        [np.asarray(s["a2m"]["v"], np.int64) + m_offs[k] for k, s in enumerate(subs)]
    ).astype(np.int32) if subs else np.zeros(0, np.int32)

    # Pooling edges: RoI-node ↔ global-node within pooling_dist.
    pool_ru_parts, pool_gv_parts = [], []
    for k, sub in enumerate(subs):
        ru, gv = _threshold_edges(sub["feats"][:, :2], g_ctrs, pooling_dist)
        pool_ru_parts.append(ru + m_offs[k])
        pool_gv_parts.append(gv)
    pool_ru = (
        np.concatenate(pool_ru_parts).astype(np.int32)
        if pool_ru_parts
        else np.zeros(0, np.int32)
    )
    pool_gv = (
        np.concatenate(pool_gv_parts).astype(np.int32)
        if pool_gv_parts
        else np.zeros(0, np.int32)
    )

    # Focal agent (first valid agent, reference lanercnn.py:148-149).
    if num_subs:
        focal = int(valid_ids[0])
        ctr = np.asarray(scen["ctrs"][focal], np.float32)
        last_dir = np.asarray(scen["feats"][focal, -1, :2], np.float32)
        n = float(np.linalg.norm(last_dir))
        agt_dir = last_dir / n if n >= 1e-6 else np.zeros(2, np.float32)
        trajs = np.asarray(scen["obs_trajs"][focal, :, :2], np.float32)
        traj_dirs = np.asarray(scen["feats"][focal, :, :2], np.float32)
        gt_world = scen["gt_preds"][focal]
        gt = (scen["rot"] @ (gt_world - scen["orig"][None, :]).T).T.astype(np.float32)
        has = np.asarray(scen["has_preds"][focal], np.float32)
        meta = np.concatenate(
            [ctr, agt_dir, np.float32([subs[0]["agent_vel"]]),
             trajs.ravel(), traj_dirs.ravel(), gt.ravel(), has]
        )
        # traj-point → interest-node refinement edges (interest RoI = sub 0).
        iu, tv = _threshold_edges(subs[0]["feats"][:, :2], trajs, pooling_dist)
        int_nn = int(sub_counts[0])
    else:
        meta = np.zeros(5 + 4 * t_hist + 3 * model_cfg.num_preds, np.float32)
        iu = tv = np.zeros(0, np.int64)
        int_nn = 0

    cache = {
        "key": key,
        "num_subs": num_subs,
        "tot_nodes": tot,
        "int_nn": int_nn,
        "nn_g": int(scen["graph"]["num_nodes"]),
        "sub_counts": sub_counts,
        "rnode_blob": rnode_blob,
        "rband_blob": rband_blob,
        "redge_u": np.concatenate(us) if us else np.zeros(0, np.int32),
        "redge_v": np.concatenate(vs) if vs else np.zeros(0, np.int32),
        "redge_counts": np.asarray(counts, np.int64),
        "agent_feat": (
            np.stack([np.asarray(s["agent_feat"], np.float32) for s in subs])
            if subs
            else np.zeros((0, 4 * t_hist), np.float32)
        ),
        "agent_vel": np.asarray([s["agent_vel"] for s in subs], np.float32),
        "a2m_u": a2m_u,
        "a2m_v": a2m_v,
        "pool_ru": pool_ru,
        "pool_gv": pool_gv,
        "a2r_u": iu.astype(np.int32),
        "a2r_v": tv.astype(np.int32),
        "meta": meta,
    }
    scen["_roi_pack"] = cache
    return cache


def pack_roi_batch(
    scenarios: Sequence[Dict],
    roi_cfg: RoiPackConfig,
    model_cfg: ModelConfig,
    pooling_dist: float = 6.0,
    split_bands: bool = True,
    split_tables: bool = True,
) -> Tuple[RoiPackedBatch, Dict[str, int]]:
    """Scenarios must carry "subgraphs"/"valid_agent_ids" (lane_roi.py) in
    addition to the base featurization + graph.

    split_bands: as in pack_batch — RoI subgraph nodes are lane-contiguous
    runs too, so intra-lane pre/suc edges (v = u + band_shift) become [M]
    band masks and the edge lists keep only the cross-lane residue.

    split_tables: neighbor tables for left/right, both in the shared GLOBAL
    lane graph (pack_batch semantics) and in the RoI subgraphs (first edge
    per destination → [M] table + combined inverse for the backward;
    duplicate-destination overflow stays in the edge lists)."""
    names = relation_names(model_cfg.num_scales)
    b_cap, r_cap = roi_cfg.max_scenarios, roi_cfg.max_rois
    m_cap, mi_cap = roi_cfg.max_roi_nodes, roi_cfg.max_interest_nodes
    g_cap = roi_cfg.max_global_nodes or m_cap
    t_hist, t_pred = model_cfg.num_hist, model_cfg.num_preds
    num_rel = len(names)
    stride = roi_cfg.node_stride
    g_stride = roi_cfg.g_stride
    if stride is not None:
        assert m_cap % stride == 0, (
            f"windowed RoI layout requires max_roi_nodes ({m_cap}) to be a "
            f"multiple of node_stride ({stride})"
        )
    if g_stride is not None:
        assert g_cap % g_stride == 0, (
            f"windowed global layout requires max_global_nodes ({g_cap}) to "
            f"be a multiple of global stride ({g_stride})"
        )
    plan_cap = roi_cfg.max_plan_edges if stride else 0
    if not roi_cfg.table_relations:
        split_tables = False

    # Shared global lane graph via the LaneGCN packer (fusion edges unused).
    gcfg = PackConfig(
        max_scenarios=b_cap,
        # Generous: the global-graph packer must accept every scenario this
        # packer accepted (its skip would desync offsets — asserted below;
        # the acceptance pass below mirrors pack_batch's window placement
        # exactly so the budgets agree).
        max_actors=64 * b_cap,
        max_nodes=g_cap,  # global nodes ≤ Σ roi nodes; typically ~2x less
        max_edges_scale0=roi_cfg.max_edges_scale0,
        max_edges_dilated=roi_cfg.max_edges_dilated,
        max_edges_lr=roi_cfg.max_edges_lr,
        max_a2m_edges=1,
        max_m2a_edges=1,
        max_a2a_edges=1,
        node_stride=roi_cfg.g_stride,
        max_plan_edges=roi_cfg.g_plan_edges,
        table_relations=roi_cfg.table_relations,
    )

    stats = {"skipped_scenarios": 0, "packed_scenarios": 0}

    # --- acceptance pass ---
    accepted: List[Dict] = []  # roi caches
    used: List[Dict] = []  # scenario dicts (for the global-graph packer)
    roi_start_list: List[int] = []  # per-RoI placed start rows (flat)
    m_off = r_off = mi_off = g_off = 0
    packer = WindowBinPacker(stride, m_cap // stride) if stride else None
    for scen in scenarios:
        c = precompute_roi_cache(scen, model_cfg, pooling_dist)
        # Bin-pack at ROI granularity (RoIs are ~70-150 nodes: ~97% window
        # fill, no straddle, every RoI-local edge window-local); the global
        # graph mirrors pack_batch's scenario-granular placement so budgets
        # stay in sync with its packer.
        reject = (
            len(accepted) >= b_cap
            or c["num_subs"] == 0
            or r_off + c["num_subs"] > r_cap
            or mi_off + c["int_nn"] > mi_cap
        )
        g_start = window_place(g_off, c["nn_g"], g_stride)
        reject = reject or g_start + c["nn_g"] > g_cap
        starts = None
        if not reject:
            if packer is not None:
                starts = packer.try_place(c["sub_counts"])
                reject = starts is None
            else:
                starts = (m_off + np.concatenate(
                    [[0], np.cumsum(c["sub_counts"][:-1])]
                ).astype(np.int64)).tolist()
                reject = m_off + c["tot_nodes"] > m_cap
        if reject:
            stats["skipped_scenarios"] += 1
            continue
        accepted.append(c)
        used.append(scen)
        roi_start_list += [int(x) for x in starts]
        m_off += c["tot_nodes"]
        r_off += c["num_subs"]
        mi_off += c["int_nn"]
        g_off = g_start + c["nn_g"]
    si = len(accepted)
    stats["packed_scenarios"] = si
    stats["num_rois"] = r_off
    stats["num_roi_nodes"] = m_off
    stats["num_interest_nodes"] = mi_off
    # Submission identity in packed order (reference data.py:364-434).
    stats["seq_ids"] = [int(s.get("seq_id", i)) for i, s in enumerate(used)]
    stats["cities"] = [str(s.get("city", "")) for s in used]

    # M = concatenated RoI-node rows (m_off additionally counts window
    # alignment gaps under the RoI-granular placement)
    R, MI = r_off, mi_off
    M = int(sum(c["tot_nodes"] for c in accepted))
    tot_arr = np.asarray([c["tot_nodes"] for c in accepted], np.int64)
    sub_arr = np.asarray([c["num_subs"] for c in accepted], np.int64)
    int_arr = np.asarray([c["int_nn"] for c in accepted], np.int64)
    g_arr = np.asarray([c["nn_g"] for c in accepted], np.int64)
    roi_starts = np.asarray(roi_start_list, np.int64)
    r_offs = np.zeros(si, np.int64)
    mi_offs = np.zeros(si, np.int64)
    g_offs = np.zeros(si, np.int64)
    if si:
        np.cumsum(sub_arr[:-1], out=r_offs[1:])
        np.cumsum(int_arr[:-1], out=mi_offs[1:])
        if g_stride is not None:
            # mirror pack_batch's window placement for the global graph
            g = 0
            for i, nn_g in enumerate(g_arr):
                g_offs[i] = window_place(g, int(nn_g), g_stride)
                g = g_offs[i] + int(nn_g)
        else:
            np.cumsum(g_arr[:-1], out=g_offs[1:])

    # --- vectorized assembly ---
    node_feats = np.zeros((m_cap, 8), np.float32)
    node_mask = np.zeros(m_cap, bool)
    node_roi = np.zeros(m_cap, np.int32)
    agent_feat = np.zeros((r_cap, 4 * t_hist), np.float32)
    agent_vel = np.zeros(r_cap, np.float32)
    roi_mask = np.zeros(r_cap, bool)
    roi_scen = np.zeros(r_cap, np.int32)

    int_node_idx = np.zeros(mi_cap, np.int32)
    int_node_scen = np.zeros(mi_cap, np.int32)
    int_node_mask = np.zeros(mi_cap, bool)

    agt_ctrs = np.zeros((b_cap, 2), np.float32)
    agt_dirs = np.zeros((b_cap, 2), np.float32)
    agt_vels = np.zeros(b_cap, np.float32)
    agt_trajs = np.zeros((b_cap, t_hist, 2), np.float32)
    agt_traj_dirs = np.zeros((b_cap, t_hist, 2), np.float32)
    gt_preds = np.zeros((b_cap, t_pred, 2), np.float32)
    has_preds = np.zeros((b_cap, t_pred), bool)
    scen_mask = np.zeros(b_cap, bool)

    if si:
        contig_starts = np.zeros(si, np.int64)
        np.cumsum(tot_arr[:-1], out=contig_starts[1:])
        roi_sizes = np.concatenate([c["sub_counts"] for c in accepted]).astype(np.int64)
        roi_contig = np.zeros(len(roi_sizes), np.int64)
        np.cumsum(roi_sizes[:-1], out=roi_contig[1:])
        # contiguous position -> placed global row, per RoI
        dst_rows = np.repeat(roi_starts, roi_sizes) + (
            np.arange(M, dtype=np.int64) - np.repeat(roi_contig, roi_sizes)
        )
        m_offs = contig_starts  # edge/interest math stays contiguous; the
        # dst_rows remap below converts to placed rows
        node_feats[dst_rows] = np.concatenate([c["rnode_blob"] for c in accepted])
        node_mask[dst_rows] = True
        # RoI row per node: scenario-local RoI ids + per-scenario RoI offset.
        node_roi[dst_rows] = np.repeat(
            np.repeat(r_offs, sub_arr)
            + np.concatenate([np.arange(c["num_subs"], dtype=np.int64) for c in accepted]),
            np.concatenate([c["sub_counts"] for c in accepted]),
        )
        agent_feat[:R] = np.concatenate([c["agent_feat"] for c in accepted])
        agent_vel[:R] = np.concatenate([c["agent_vel"] for c in accepted])
        roi_mask[:R] = True
        roi_scen[:R] = np.repeat(np.arange(si, dtype=np.int32), sub_arr)

        # Interest-RoI nodes are each scenario's first sub (placed rows
        # assigned after the edge-offset block below).
        int_node_scen[:MI] = np.repeat(np.arange(si, dtype=np.int32), int_arr)
        int_node_mask[:MI] = True

        meta = np.stack([c["meta"] for c in accepted])
        o = 0
        agt_ctrs[:si] = meta[:, o : o + 2]; o += 2
        agt_dirs[:si] = meta[:, o : o + 2]; o += 2
        agt_vels[:si] = meta[:, o]; o += 1
        agt_trajs[:si] = meta[:, o : o + 2 * t_hist].reshape(si, t_hist, 2); o += 2 * t_hist
        agt_traj_dirs[:si] = meta[:, o : o + 2 * t_hist].reshape(si, t_hist, 2); o += 2 * t_hist
        gt_preds[:si] = meta[:, o : o + 2 * t_pred].reshape(si, t_pred, 2); o += 2 * t_pred
        has_preds[:si] = meta[:, o:] > 0.5
        scen_mask[:si] = True

        e_counts = np.stack([c["redge_counts"] for c in accepted])  # [S, R]
        m_add = np.broadcast_to(m_offs[:, None], (si, num_rel))
        rel_u, per_rel = _segment_reorder(
            np.concatenate([c["redge_u"] for c in accepted]), e_counts, m_add
        )
        rel_v, _ = _segment_reorder(
            np.concatenate([c["redge_v"] for c in accepted]), e_counts, m_add
        )
        band_cat = np.concatenate([c["rband_blob"] for c in accepted])

        def _offset(field: str, offs: np.ndarray) -> np.ndarray:
            parts = [c[field] for c in accepted]
            lens = np.asarray([len(p) for p in parts], np.int64)
            return np.concatenate(parts).astype(np.int64) + np.repeat(offs, lens)

        a2m_u = _offset("a2m_u", r_offs)
        a2m_v = dst_rows[_offset("a2m_v", m_offs)]
        pool_ru = dst_rows[_offset("pool_ru", m_offs)]
        pool_gv = _offset("pool_gv", g_offs)
        a2r_u = _offset("a2r_u", mi_offs)
        a2r_v = _offset("a2r_v", np.arange(si, dtype=np.int64) * t_hist)
        # RoI relation edges: contiguous coords -> placed rows
        rel_u = dst_rows[rel_u]
        rel_v = dst_rows[rel_v]
        # interest nodes = the first RoI's rows per scenario (contiguous
        # within that RoI after placement)
        int_node_idx[:MI] = dst_rows[
            np.repeat(m_offs, int_arr) + np.concatenate(
                [np.arange(c["int_nn"], dtype=np.int64) for c in accepted]
            )
        ]
    else:
        rel_u = rel_v = np.zeros(0, np.int64)
        per_rel = np.zeros(num_rel, np.int64)
        band_cat = np.zeros((0, 2 * model_cfg.num_scales), bool)
        a2m_u = a2m_v = pool_ru = pool_gv = a2r_u = a2r_v = np.zeros(0, np.int64)
        dst_rows = np.zeros(0, np.int64)

    graph_batch, gstats = pack_batch(
        used, gcfg, model_cfg, split_bands=split_bands, split_tables=split_tables
    )
    assert gstats["packed_scenarios"] == si, (gstats, si)
    for k, v in gstats.items():
        # Fusion edges of the global-graph packer are unused by LaneRCNN
        # (capacity 1 by construction) — don't report their drops.
        if k.startswith("dropped") and v and k[8:] not in ("a2m", "m2a", "a2a"):
            stats[f"graph_{k}"] = v

    bands = {} if split_bands else None
    tables = {} if split_tables else None
    pend = {}
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
                mask = np.zeros(m_cap, bool)
                mask[dst_rows] = col
                bands[nm] = mask
                stats[f"banded_{nm}"] = int(col.sum())
            else:
                bu = dst_rows[col]
                u = np.concatenate([u, bu])
                v = np.concatenate([v, bu + shift])
        if split_tables and nm in ("left", "right"):
            # RoI left/right are functional like the global graph's (nearest
            # matches restricted to the subgraph) — first edge per
            # destination rides a [M] neighbor table, duplicates overflow.
            tbl, u, v = _split_first_per_destination(u, v, m_cap)
            tables[nm] = tbl
            stats[f"tabled_{nm}"] = int(np.sum(tbl < m_cap))
        pend[nm] = (u, v)

    table_inv = None
    if split_tables:
        table_inv = _build_table_inverse(
            tables, names, m_cap, roi_cfg.table_edge_capacity, pend, stats
        )

    plan_lu = plan_lv = plan_rel = None
    if plan_cap:
        plan_lu, plan_lv, plan_rel = build_window_plan(
            pend, names, stride, m_cap // stride, plan_cap, stats
        )

    edges = {}
    for nm in names:
        u, v = pend[nm]
        edges[nm], dropped = _pad_edges(u, v, roi_cfg.edge_capacity(nm))
        stats[f"dropped_{nm}"] = dropped

    def _fuse(u, v, cap, name, num_src=None, dst_stride=None):
        window = (
            roi_cfg.window_pool_edges
            and num_src is not None
            and dst_stride
            and cap % WCHUNK == 0
        )
        if window:
            # Destination windows exist: chunk-align per window so the
            # LanePooling scatter runs as a per-row segment sum over each
            # window's chunks (ops/window_scatter).
            # Alignment padding means a capacity that fit the flat layout
            # can drop edges here — warn loudly, don't just count.
            es, dropped = window_chunked_edges(u, v, cap, dst_stride, num_src)
            if dropped:
                warnings.warn(
                    f"window-chunked {name} edges dropped {dropped} of "
                    f"{len(u)} (capacity {cap}, chunk {WCHUNK}): raise "
                    f"max_pool_edges or set RoiPackConfig."
                    f"window_pool_edges=False (training-signal change)",
                    stacklevel=2,
                )
        elif num_src is not None:
            es, dropped = _pad_edges_sorted(u, v, cap, num_src)
        else:
            es, dropped = _pad_edges(u, v, cap)
        stats[f"dropped_{name}"] = dropped
        return es

    a2m = _fuse(a2m_u, a2m_v, roi_cfg.max_a2m_edges, "a2m")
    # Pool edges ride the destination-sorted layout: the LanePooling
    # scatter runs indices_are_sorted and the context-feature gather's
    # backward uses the source-sorted inverse (these are the two largest
    # edge lists in the model — ~5k per scenario each way). With windowed
    # node layouts they are additionally chunk-aligned per dst window.
    r2g = _fuse(
        pool_gv, pool_ru, roi_cfg.max_pool_edges, "r2g", m_cap,
        dst_stride=g_stride,
    )  # dest=global, src=roi
    g2r = _fuse(
        pool_ru, pool_gv, roi_cfg.max_pool_edges, "g2r", g_cap,
        dst_stride=stride,
    )  # dest=roi, src=global
    a2r = _fuse(a2r_u, a2r_v, roi_cfg.max_a2r_edges, "a2r")

    batch = RoiPackedBatch(
        node_feats=node_feats,
        node_mask=node_mask,
        node_roi=node_roi,
        agent_feat=agent_feat,
        agent_vel=agent_vel,
        roi_mask=roi_mask,
        roi_scen=roi_scen,
        edges=edges,
        a2m=a2m,
        graph=graph_batch.graph,
        r2g=r2g,
        g2r=g2r,
        int_node_idx=int_node_idx,
        int_node_scen=int_node_scen,
        int_node_mask=int_node_mask,
        a2r=a2r,
        agt_ctrs=agt_ctrs,
        agt_dirs=agt_dirs,
        agt_vels=agt_vels,
        agt_trajs=agt_trajs,
        agt_traj_dirs=agt_traj_dirs,
        gt_preds=gt_preds,
        has_preds=has_preds,
        scen_mask=scen_mask,
        bands=bands,
        tables=tables,
        table_inv=table_inv,
        plan_lu=plan_lu,
        plan_lv=plan_lv,
        plan_rel=plan_rel,
        plan_scen=(m_cap // stride) if plan_cap else 0,
    )
    return batch, stats
