"""Lane-graph construction (reference data.py:220-361, preprocess_data.py:287-392).

Nodes are centerline *segments* (midpoint + direction). Edges:
- pre/suc scale 0: intra-lane chain links + cross-lane links through lane
  predecessors/successors,
- pre/suc scales 1..S-1: dilated neighbors — boolean sparse adjacency squared
  repeatedly, giving exact 2^i-hop reachability (reference dilated_nbrs
  data.py:520-534),
- left/right: nearest direction-compatible node of a (reachability-expanded)
  left/right neighbor lane within cross_dist (reference preprocess()
  preprocess_data.py:287-392).

All host-side numpy/scipy; runs offline or in the input pipeline.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy import sparse


class Lane:
    """Minimal lane record (mirrors the Argoverse map API surface the
    reference consumes — centerline + topology + semantic flags)."""

    def __init__(
        self,
        lane_id: int,
        centerline: np.ndarray,  # [P, 2]
        predecessors: Sequence[int] = (),
        successors: Sequence[int] = (),
        left_neighbor: Optional[int] = None,
        right_neighbor: Optional[int] = None,
        turn_direction: str = "NONE",  # NONE | LEFT | RIGHT
        has_traffic_control: bool = False,
        is_intersection: bool = False,
    ):
        self.id = lane_id
        self.centerline = np.asarray(centerline, np.float32)
        self.predecessors = list(predecessors)
        self.successors = list(successors)
        self.left_neighbor = left_neighbor
        self.right_neighbor = right_neighbor
        self.turn_direction = turn_direction
        self.has_traffic_control = has_traffic_control
        self.is_intersection = is_intersection


def dilated_nbrs(u: np.ndarray, v: np.ndarray, num_nodes: int, num_scales: int):
    """Boolean CSR adjacency squared per scale: scale i = exact 2^i-hop pairs.

    scipy SpGEMM (the reference's approach, data.py:520-534)."""
    data = np.ones(len(u), bool)
    mat = sparse.csr_matrix((data, (u, v)), shape=(num_nodes, num_nodes))
    out = []
    for _ in range(1, num_scales):
        mat = mat * mat
        coo = mat.tocoo()
        out.append((coo.row.astype(np.int32), coo.col.astype(np.int32)))
    return out


def dilated_nbrs2(u: np.ndarray, v: np.ndarray, num_nodes: int, scales: Sequence[int]):
    """Explicit-scale variant: repeated A*A₀ products, emitting scales from
    the given list (reference dilated_nbrs2 data.py:537-552; used when
    config["scales"] overrides the power-of-two dilation)."""
    data = np.ones(len(u), bool)
    csr = sparse.csr_matrix((data, (u, v)), shape=(num_nodes, num_nodes))
    mat = csr
    out = []
    for i in range(1, max(scales)):
        mat = mat * csr
        if i + 1 in scales:
            coo = mat.tocoo()
            out.append((coo.row.astype(np.int32), coo.col.astype(np.int32)))
    return out


def _pairs_matrix(pairs: np.ndarray, num_lanes: int) -> np.ndarray:
    mat = np.zeros((num_lanes, num_lanes), np.float32)
    if len(pairs):
        mat[pairs[:, 0], pairs[:, 1]] = 1
    return mat


def _cross_edges(
    side_pairs: np.ndarray,
    pre: np.ndarray,
    suc: np.ndarray,
    lane_idcs: np.ndarray,
    dist: np.ndarray,
    feats: np.ndarray,
    cross_dist: float,
    sector_block: Optional[np.ndarray],
    ctrs: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Nearest valid node of the side-neighbor lane set, direction-filtered
    (reference preprocess_data.py:315-349)."""
    if len(side_pairs) == 0:
        return {"u": np.zeros(0, np.int32), "v": np.zeros(0, np.int32)}
    num_lanes = pre.shape[0]
    mat = _pairs_matrix(side_pairs, num_lanes)
    # Expand side-neighborhood through lane pre/suc so adjacent segments of
    # connected lanes qualify too.
    reach = (mat @ pre + mat @ suc + mat) > 0.5

    allowed = reach[lane_idcs[:, None], lane_idcs[None, :]]
    side_dist = np.where(allowed, dist, 1e6)
    if sector_block is not None:
        side_dist = np.where(sector_block, 1e6, side_dist)

    min_idcs = side_dist.argmin(axis=1)
    min_dist = side_dist[np.arange(len(min_idcs)), min_idcs]
    mask = min_dist < cross_dist
    ui = np.arange(len(min_idcs))[mask]
    vi = min_idcs[mask]

    # Direction compatibility: |Δheading| < π/4 (reference preprocess_data.py:336-346).
    t1 = np.arctan2(feats[ui, 1], feats[ui, 0])
    t2 = np.arctan2(feats[vi, 1], feats[vi, 0])
    dt = np.abs(t1 - t2)
    dt = np.where(dt > np.pi, np.abs(dt - 2 * np.pi), dt)
    keep = dt < 0.25 * np.pi
    return {"u": ui[keep].astype(np.int32), "v": vi[keep].astype(np.int32)}


def build_lane_graph(
    lanes: Sequence[Lane],
    num_scales: int = 6,
    cross_dist: float = 6.0,
    cross_angle: Optional[float] = None,
    scales: Optional[Sequence[int]] = None,
) -> Dict:
    """Sequence of Lane records → node-level graph dict.

    Returns keys: ctrs, feats, turn, control, intersect [per node];
    pre/suc: list of num_scales {u, v}; left/right: {u, v}; lane_idcs;
    num_nodes. cross_angle=None matches the reference's effective pipeline
    (preprocess_data.py:250 calls preprocess() without cross_angle, leaving
    the bearing-sector gate disabled despite config naming it).
    """
    lane_ids = [ln.id for ln in lanes]
    id_to_idx = {lid: i for i, lid in enumerate(lane_ids)}

    ctrs, feats, turn, control, intersect = [], [], [], [], []
    node_ranges = []
    count = 0
    for ln in lanes:
        cl = ln.centerline
        num_segs = len(cl) - 1
        ctrs.append(((cl[:-1] + cl[1:]) / 2.0).astype(np.float32))
        feats.append((cl[1:] - cl[:-1]).astype(np.float32))
        x = np.zeros((num_segs, 2), np.float32)
        if ln.turn_direction == "LEFT":
            x[:, 0] = 1
        elif ln.turn_direction == "RIGHT":
            x[:, 1] = 1
        turn.append(x)
        control.append(float(ln.has_traffic_control) * np.ones(num_segs, np.float32))
        intersect.append(float(ln.is_intersection) * np.ones(num_segs, np.float32))
        node_ranges.append(range(count, count + num_segs))
        count += num_segs
    num_nodes = count

    pre_u, pre_v, suc_u, suc_v = [], [], [], []
    for i, ln in enumerate(lanes):
        idcs = list(node_ranges[i])
        pre_u += idcs[1:]
        pre_v += idcs[:-1]
        for nbr in ln.predecessors:
            if nbr in id_to_idx:
                pre_u.append(idcs[0])
                pre_v.append(list(node_ranges[id_to_idx[nbr]])[-1])
        suc_u += idcs[:-1]
        suc_v += idcs[1:]
        for nbr in ln.successors:
            if nbr in id_to_idx:
                suc_u.append(idcs[-1])
                suc_v.append(list(node_ranges[id_to_idx[nbr]])[0])

    lane_idcs = np.concatenate(
        [i * np.ones(len(node_ranges[i]), np.int64) for i in range(len(lanes))]
    ) if lanes else np.zeros(0, np.int64)

    pre_pairs, suc_pairs, left_pairs, right_pairs = [], [], [], []
    for i, ln in enumerate(lanes):
        for nbr in ln.predecessors:
            if nbr in id_to_idx:
                pre_pairs.append([i, id_to_idx[nbr]])
        for nbr in ln.successors:
            if nbr in id_to_idx:
                suc_pairs.append([i, id_to_idx[nbr]])
        if ln.left_neighbor is not None and ln.left_neighbor in id_to_idx:
            left_pairs.append([i, id_to_idx[ln.left_neighbor]])
        if ln.right_neighbor is not None and ln.right_neighbor in id_to_idx:
            right_pairs.append([i, id_to_idx[ln.right_neighbor]])
    pre_pairs = np.asarray(pre_pairs, np.int64).reshape(-1, 2)
    suc_pairs = np.asarray(suc_pairs, np.int64).reshape(-1, 2)
    left_pairs = np.asarray(left_pairs, np.int64).reshape(-1, 2)
    right_pairs = np.asarray(right_pairs, np.int64).reshape(-1, 2)

    graph = {
        "ctrs": np.concatenate(ctrs, 0) if ctrs else np.zeros((0, 2), np.float32),
        "feats": np.concatenate(feats, 0) if feats else np.zeros((0, 2), np.float32),
        "turn": np.concatenate(turn, 0) if turn else np.zeros((0, 2), np.float32),
        "control": np.concatenate(control, 0) if control else np.zeros(0, np.float32),
        "intersect": np.concatenate(intersect, 0) if intersect else np.zeros(0, np.float32),
        "num_nodes": num_nodes,
        "lane_idcs": lane_idcs,
        "pre_pairs": pre_pairs,
        "suc_pairs": suc_pairs,
        "left_pairs": left_pairs,
        "right_pairs": right_pairs,
    }

    pre0 = {"u": np.asarray(pre_u, np.int32), "v": np.asarray(pre_v, np.int32)}
    suc0 = {"u": np.asarray(suc_u, np.int32), "v": np.asarray(suc_v, np.int32)}
    graph["pre"] = [pre0]
    graph["suc"] = [suc0]
    if num_nodes > 0:
        if scales is not None:
            # Explicit dilation list (reference data.py:356-358).
            for (du, dv) in dilated_nbrs2(pre0["u"], pre0["v"], num_nodes, scales):
                graph["pre"].append({"u": du, "v": dv})
            for (du, dv) in dilated_nbrs2(suc0["u"], suc0["v"], num_nodes, scales):
                graph["suc"].append({"u": du, "v": dv})
        else:
            for (du, dv) in dilated_nbrs(pre0["u"], pre0["v"], num_nodes, num_scales):
                graph["pre"].append({"u": du, "v": dv})
            for (du, dv) in dilated_nbrs(suc0["u"], suc0["v"], num_nodes, num_scales):
                graph["suc"].append({"u": du, "v": dv})
    else:
        empty = {"u": np.zeros(0, np.int32), "v": np.zeros(0, np.int32)}
        graph["pre"] += [dict(empty) for _ in range(num_scales - 1)]
        graph["suc"] += [dict(empty) for _ in range(num_scales - 1)]

    # Left/right node-level edges (reference preprocess_data.py:287-392).
    if num_nodes > 0:
        d = graph["ctrs"][:, None, :] - graph["ctrs"][None, :, :]
        dist = np.sqrt((d ** 2).sum(2))
        sector_left = sector_right = None
        if cross_angle is not None:
            f2 = graph["ctrs"][None, :, :] - graph["ctrs"][:, None, :]
            t1 = np.arctan2(graph["feats"][:, 1], graph["feats"][:, 0])[:, None]
            t2 = np.arctan2(f2[..., 1], f2[..., 0])
            dt = t2 - t1
            dt = np.where(dt > 2 * np.pi, dt - 2 * np.pi, dt)
            dt = np.where(dt < -2 * np.pi, dt + 2 * np.pi, dt)
            sector_left = ~np.logical_and(dt > 0, dt < cross_angle)
            sector_right = ~np.logical_and(dt < 0, dt > -cross_angle)
        num_lanes = len(lanes)
        pre_m = _pairs_matrix(pre_pairs, num_lanes)
        suc_m = _pairs_matrix(suc_pairs, num_lanes)
        graph["left"] = _cross_edges(
            left_pairs, pre_m, suc_m, lane_idcs, dist, graph["feats"], cross_dist,
            sector_left, ctrs=graph["ctrs"],
        )
        graph["right"] = _cross_edges(
            right_pairs, pre_m, suc_m, lane_idcs, dist, graph["feats"], cross_dist,
            sector_right, ctrs=graph["ctrs"],
        )
    else:
        graph["left"] = {"u": np.zeros(0, np.int32), "v": np.zeros(0, np.int32)}
        graph["right"] = {"u": np.zeros(0, np.int32), "v": np.zeros(0, np.int32)}
    return graph
