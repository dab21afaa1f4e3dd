"""Per-agent LaneRoI subgraph generation (reference data_lrcnn.py:614-844).

For each moving agent: estimate longitudinal velocity from its history, find
the nearest direction-compatible lane node, BFS the lane-level suc/pre
adjacency out to speed-scaled horizons, close over left/right neighbor lanes,
and extract the node subset as an 8-dim-feature subgraph with re-indexed
pre/suc×scales, left/right edges, plus agent→map edges for nodes within 5 m.

The port's own copy of the JAX package's RoI generator (numpy only): the
same subgraphs, array for array.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _polyline_length(feats: np.ndarray) -> float:
    if len(feats) == 0:
        return 0.0
    return float(np.sum(np.sqrt(np.sum(np.square(feats), axis=-1))))


def lanes_within_horizon(
    edge_mat: np.ndarray,
    target_lane: int,
    lane_idcs: np.ndarray,
    feats: np.ndarray,
    horizon: float,
) -> List[int]:
    """BFS over the lane adjacency, accumulating the min frontier lane length
    per hop until the horizon is covered (reference get_lanes_with_dfs
    data_lrcnn.py:620-645)."""
    num_lanes = len(edge_mat)
    mat = np.zeros((1, num_lanes), dtype=bool)
    mat[0, target_lane] = True
    found: List[int] = []
    dist_sum = _polyline_length(feats[lane_idcs == target_lane])
    while dist_sum < horizon:
        mat = np.matmul(mat, edge_mat)
        lids = np.nonzero(mat)[1]
        if len(lids) == 0:
            break
        dists = []
        for lid in lids:
            dists.append(_polyline_length(feats[lane_idcs == lid]))
            found.append(int(lid))
        dist_sum += min(dists)
    return found


def neighbor_closure(nbr_mat: np.ndarray, lanes: List[int]) -> np.ndarray:
    """Transitive closure over the left/right adjacency (reference
    get_nbr_set data_lrcnn.py:653-664)."""
    num_lanes = len(nbr_mat)
    mat = np.zeros((1, num_lanes), dtype=bool)
    nbrs = np.unique(np.asarray(lanes, np.int64))
    mat[0, nbrs] = True
    while True:
        mat = np.matmul(mat, nbr_mat)
        lane_ids = np.nonzero(mat)[1]
        if np.all(np.isin(lane_ids, nbrs)):
            break
        nbrs = np.unique(np.concatenate([nbrs, lane_ids]))
    return nbrs


def agent_velocities(agent_feats: np.ndarray, cycle_time: float = 0.1) -> np.ndarray:
    """Longitudinal speed from motion deltas (reference
    get_velocity_per_agent data_lrcnn.py:666-684)."""
    num_agents, t = agent_feats.shape[0], agent_feats.shape[1]
    step_dist = np.sqrt((agent_feats[:, :, :2] ** 2).sum(-1))  # [A, T]
    mask = step_dist > 0
    increment = 0.1 * np.arange(t) / t
    last = mask.astype(float) + increment
    first = mask.astype(float) - increment
    last_val, last_idc = last.max(1), last.argmax(1)
    first_idc = first.argmax(1)
    duration = (last_idc - first_idc + 1) * cycle_time
    vel = np.zeros(num_agents, np.float32)
    valid = last_val >= 1.0
    vel[valid] = step_dist.sum(1)[valid] / duration[valid]
    return vel


def generate_lane_rois(
    data: Dict,
    num_scales: int = 6,
    horizon_buffer: float = 20.0,
    a2m_dist: float = 5.0,
    min_nodes: int = 6,
) -> Dict:
    """Adds data["subgraphs"] (list of per-agent RoI dicts) and
    data["valid_agent_ids"]. Mirrors reference generate_lane_roi
    (data_lrcnn.py:690-844) with dense boolean relation matrices."""
    graph = data["graph"]
    lane_idcs = np.asarray(graph["lane_idcs"], np.int64)
    num_lanes = int(lane_idcs[-1]) + 1 if len(lane_idcs) else 0
    num_nodes = len(lane_idcs)
    agent_feats = data["feats"]
    agent_ctrs = data["ctrs"]
    num_agents = len(agent_ctrs)

    dist = np.expand_dims(graph["ctrs"], 1) - np.expand_dims(agent_ctrs, 0)
    dist = np.sqrt((dist ** 2).sum(-1))  # [N, A]
    sorted_nodes = dist.argsort(axis=0)
    close_nodes, close_agents = np.nonzero(dist < a2m_dist)

    # Lane-level adjacency.
    pre = np.zeros((num_lanes, num_lanes), bool)
    suc = np.zeros((num_lanes, num_lanes), bool)
    side = np.zeros((num_lanes, num_lanes), bool)
    if len(graph["pre_pairs"]):
        pre[graph["pre_pairs"][:, 0], graph["pre_pairs"][:, 1]] = True
    if len(graph["suc_pairs"]):
        suc[graph["suc_pairs"][:, 0], graph["suc_pairs"][:, 1]] = True
    for k in ("left", "right"):
        e = graph[k]
        if len(e["u"]):
            side[lane_idcs[np.asarray(e["u"])], lane_idcs[np.asarray(e["v"])]] = True

    # Node-level relation matrices for subgraph slicing.
    node_rel = {}
    for k1 in ("pre", "suc"):
        node_rel[k1] = []
        for s in range(num_scales):
            m = np.zeros((num_nodes, num_nodes), bool)
            e = graph[k1][s]
            m[np.asarray(e["u"]), np.asarray(e["v"])] = True
            node_rel[k1].append(m)
    for k1 in ("left", "right"):
        m = np.zeros((num_nodes, num_nodes), bool)
        e = graph[k1]
        m[np.asarray(e["u"]), np.asarray(e["v"])] = True
        node_rel[k1] = m

    vels = agent_velocities(agent_feats)
    subgraphs, valid_ids = [], []
    for a in range(num_agents):
        if vels[a] == 0:
            continue
        suc_horizon = vels[a] * 3.0 + horizon_buffer
        pre_horizon = vels[a] * 2.0 + horizon_buffer

        # Nearest direction-compatible node (Δθ < π/4, fallback π/2).
        cur_dir = agent_feats[a, -1, :2]
        order = sorted_nodes[:, a]
        node_dirs = graph["feats"][order]
        t1 = np.arctan2(cur_dir[1], cur_dir[0])
        t2 = np.arctan2(node_dirs[:, 1], node_dirs[:, 0])
        dt = np.abs(t1 - t2)
        dt = np.where(dt > np.pi, np.abs(dt - 2 * np.pi), dt)
        cand = order[dt < 0.25 * np.pi]
        if len(cand) == 0:
            cand = order[dt < 0.5 * np.pi]
            if len(cand) == 0:
                continue
        node_id = int(cand[0])

        target_lane = int(lane_idcs[node_id])
        lanes = [target_lane]
        lanes += lanes_within_horizon(suc, target_lane, lane_idcs, graph["feats"], suc_horizon)
        lanes += lanes_within_horizon(pre, target_lane, lane_idcs, graph["feats"], pre_horizon)
        roi_lanes = neighbor_closure(side, lanes)

        node_mask = np.concatenate(
            [np.nonzero(lane_idcs == l)[0] for l in roi_lanes]
        ) if len(roi_lanes) else np.zeros(0, np.int64)
        if len(node_mask) < min_nodes:
            continue

        feats8 = np.zeros((len(node_mask), 8), np.float32)
        feats8[:, :2] = graph["ctrs"][node_mask]
        feats8[:, 2:4] = graph["feats"][node_mask]
        feats8[:, 4:6] = graph["turn"][node_mask]
        feats8[:, 6] = graph["control"][node_mask]
        feats8[:, 7] = graph["intersect"][node_mask]

        motion = np.concatenate(
            [data["obs_trajs"][a, :, :2], data["feats"][a, :, :2]], axis=-1
        )  # [T_hist, 4]

        interest = close_nodes[close_agents == a]
        assoc = np.nonzero(np.isin(node_mask, interest))[0].astype(np.int32)

        sub = {
            "node_mask": node_mask,
            "num_nodes": len(node_mask),
            "feats": feats8,
            "agent_feat": motion.reshape(-1),  # [T_hist*4] = 80
            "agent_vel": float(vels[a]),
            "a2m": {"u": np.zeros(len(assoc), np.int32), "v": assoc},
        }
        for k1 in ("pre", "suc"):
            sub[k1] = []
            for s in range(num_scales):
                us, vs = np.nonzero(node_rel[k1][s][node_mask][:, node_mask])
                sub[k1].append({"u": us.astype(np.int32), "v": vs.astype(np.int32)})
        if len(sub["pre"][0]["u"]) == 0 and len(sub["suc"][0]["u"]) == 0:
            continue
        for k1 in ("left", "right"):
            us, vs = np.nonzero(node_rel[k1][node_mask][:, node_mask])
            sub[k1] = {"u": us.astype(np.int32), "v": vs.astype(np.int32)}

        subgraphs.append(sub)
        valid_ids.append(a)

    data["subgraphs"] = subgraphs
    data["valid_agent_ids"] = np.asarray(valid_ids, np.int64)
    return data
