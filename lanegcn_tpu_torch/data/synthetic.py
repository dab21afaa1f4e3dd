"""Synthetic lane-graph scenario generator.

Stands in for Argoverse raw data (unavailable offline) with statistically
similar scenarios: corridors of parallel connected lanes (successor chains,
left/right neighbors, 2.5 m segments), agents following lanes with noise,
partial observation dropout. Feeds the exact production pipeline
(featurize_scenario + build_lane_graph), so tests and benchmarks exercise
the real code path at realistic sizes (~600-1500 lane nodes, 5-25 actors).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from lanegcn_tpu_torch.data.featurize import featurize_scenario
from lanegcn_tpu_torch.data.lane_graph import Lane, build_lane_graph
from lanegcn_tpu_torch.data.lane_roi import generate_lane_rois


def _make_corridor(
    rng: np.random.Generator,
    lane_id0: int,
    num_parallel: int,
    chain_len: int,
    start: np.ndarray | None = None,
    heading: float | None = None,
    turn: str | None = None,
    intersection: bool | None = None,
    width_jitter: float = 0.0,
):
    """One corridor: num_parallel lanes side by side, each a chain of
    chain_len lane records with 9 segments each. Returns (lanes, paths,
    info) where info carries the junction-linking surface: first/last lane
    ids per parallel index, start/end pose."""
    seg_len = 2.5
    segs_per_lane = 9
    total = chain_len * segs_per_lane + 1
    if start is None:
        start = rng.uniform(-60, 60, size=2)
    if heading is None:
        heading = rng.uniform(0, 2 * np.pi)
    curv = rng.normal(0.0, 0.01)
    headings = heading + np.cumsum(np.full(total - 1, curv) + rng.normal(0, 0.004, total - 1))
    dirs = np.stack([np.cos(headings), np.sin(headings)], axis=1)
    base = np.concatenate([start[None, :], start[None, :] + np.cumsum(dirs * seg_len, 0)], 0)

    normal = np.stack([-dirs[:, 1], dirs[:, 0]], axis=1)
    normal = np.concatenate([normal[:1], normal], 0)

    lanes: List[Lane] = []
    lane_width = 3.5
    if turn is None:
        turn = rng.choice(["NONE", "NONE", "NONE", "LEFT", "RIGHT"])
    control = bool(rng.random() < 0.3)
    inter = bool(rng.random() < 0.2) if intersection is None else intersection
    ids = np.arange(num_parallel * chain_len).reshape(num_parallel, chain_len) + lane_id0
    offsets = []
    off = 0.0
    for p in range(num_parallel):
        offsets.append(off)
        off += lane_width * (1.0 + (rng.normal(0, width_jitter) if width_jitter else 0.0))
    for p in range(num_parallel):
        pts = base + normal * offsets[p]
        for c in range(chain_len):
            cl = pts[c * segs_per_lane : (c + 1) * segs_per_lane + 1]
            lanes.append(
                Lane(
                    lane_id=int(ids[p, c]),
                    centerline=cl,
                    predecessors=[int(ids[p, c - 1])] if c > 0 else [],
                    successors=[int(ids[p, c + 1])] if c < chain_len - 1 else [],
                    left_neighbor=int(ids[p + 1, c]) if p + 1 < num_parallel else None,
                    right_neighbor=int(ids[p - 1, c]) if p > 0 else None,
                    turn_direction=turn,
                    has_traffic_control=control,
                    is_intersection=inter,
                )
            )
    centerline_full = [base + normal * offsets[p] for p in range(num_parallel)]
    info = {
        "first_ids": [int(ids[p, 0]) for p in range(num_parallel)],
        "last_ids": [int(ids[p, -1]) for p in range(num_parallel)],
        "num_parallel": num_parallel,
        "start_pt": base[0].copy(),
        "end_pt": base[-1].copy(),
        "end_heading": float(headings[-1]),
        "paths": centerline_full,
    }
    return lanes, centerline_full, info


def _link_corridors(by_id: Dict[int, "Lane"], up: Dict, down: Dict) -> None:
    """Topologically join corridor `up`'s end to corridor `down`'s start:
    matching parallel lanes become successor/predecessor pairs (the
    node-level graph then gets cross-lane suc/pre edges at the junction)."""
    for p in range(min(up["num_parallel"], down["num_parallel"])):
        src = by_id[up["last_ids"][p]]
        dst = by_id[down["first_ids"][p]]
        if dst.id not in src.successors:
            src.successors.append(dst.id)
        if src.id not in dst.predecessors:
            dst.predecessors.append(src.id)


def _actor_traj(rng: np.random.Generator, path: np.ndarray, num_steps: int = 50):
    """Follow a polyline path at a noisy constant speed; returns [T, 2]."""
    seg = np.diff(path, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg_len)])
    speed = rng.uniform(2.0, 12.0)
    start_s = rng.uniform(0, max(arc[-1] - speed * num_steps * 0.1, 1.0))
    s = start_s + speed * 0.1 * np.arange(num_steps)
    s = np.clip(s, 0, arc[-1] - 1e-3)
    idx = np.searchsorted(arc, s, side="right") - 1
    idx = np.clip(idx, 0, len(seg) - 1)
    frac = (s - arc[idx]) / np.maximum(seg_len[idx], 1e-6)
    pts = path[idx] + seg[idx] * frac[:, None]
    pts = pts + rng.normal(0, 0.05, pts.shape)
    return pts


def _synthetic_world(
    seed: int,
    num_corridors: int = 4,
    num_actors: int = 12,
    num_hist: int = 20,
    num_pred: int = 30,
    urban: bool = False,
) -> Tuple[List[Lane], List[np.ndarray], List[np.ndarray]]:
    """The world of make_synthetic_scenario(seed, ...) before featurizing:
    its world-frame lanes and the actors' (trajs, steps), the AGENT first."""
    rng = np.random.default_rng(seed)
    lanes: List[Lane] = []
    paths = []
    infos: List[Dict] = []
    parent_of: List[int] = []  # corridor index of the (first) parent, or -1
    by_id: Dict[int, Lane] = {}
    lane_id0 = 0
    for k in range(num_corridors):
        num_parallel = int(rng.integers(1, 4))
        chain_len = int(rng.integers(4, 8))
        start = heading = turn = None
        inter = None
        parent = None
        if urban and infos and rng.random() < 0.65:
            # Branch off an existing corridor's end. Two children of the
            # same parent = a fork (that lane gets 2 successors).
            parent = int(rng.integers(0, len(infos)))
            delta = float(rng.uniform(-0.9, 0.9))
            start = infos[parent]["end_pt"] + rng.normal(0, 0.5, 2)
            heading = infos[parent]["end_heading"] + delta
            turn = "LEFT" if delta > 0.35 else ("RIGHT" if delta < -0.35 else "NONE")
            inter = abs(delta) > 0.35
        cor_lanes, cor_paths, info = _make_corridor(
            rng, lane_id0, num_parallel, chain_len,
            start=start, heading=heading, turn=turn, intersection=inter,
            width_jitter=0.08 if urban else 0.0,
        )
        lanes += cor_lanes
        for ln in cor_lanes:
            by_id[ln.id] = ln
        if parent is not None:
            _link_corridors(by_id, infos[parent], info)
            paths.append(
                np.concatenate([infos[parent]["paths"][0], cor_paths[0]], 0)
            )
        if urban and infos and rng.random() < 0.3:
            # Merge: the nearest other corridor end also feeds this start
            # (this corridor's first lanes gain a second predecessor).
            cands = [
                (float(np.linalg.norm(infos[j]["end_pt"] - info["start_pt"])), j)
                for j in range(len(infos)) if j != parent
            ]
            if cands:
                d, j = min(cands)
                if d < 30.0:
                    _link_corridors(by_id, infos[j], info)
                    paths.append(
                        np.concatenate([infos[j]["paths"][0], cor_paths[0]], 0)
                    )
        paths += cor_paths
        infos.append(info)
        parent_of.append(-1 if parent is None else parent)
        lane_id0 += num_parallel * chain_len

    num_steps = num_hist + num_pred
    trajs, steps = [], []
    # AGENT: fully observed.
    trajs.append(_actor_traj(rng, paths[int(rng.integers(0, len(paths)))], num_steps))
    steps.append(np.arange(num_steps))
    for _ in range(num_actors - 1):
        tr = _actor_traj(rng, paths[int(rng.integers(0, len(paths)))], num_steps)
        # Random observation window (some actors appear late / disappear).
        t0 = int(rng.integers(0, num_hist))
        t1 = int(rng.integers(num_hist, num_steps + 1))
        keep = np.arange(t0, t1)
        trajs.append(tr[keep])
        steps.append(keep)

    return lanes, trajs, steps


def make_synthetic_scenario(
    seed: int,
    num_corridors: int = 4,
    num_actors: int = 12,
    num_hist: int = 20,
    num_pred: int = 30,
    num_scales: int = 6,
    urban: bool = False,
) -> Dict:
    """One scenario dict: featurized actors + node-level lane graph.

    urban=False: isolated straight corridors — every pre/suc edge is
    intra-chain (banded) and every left/right matches 1:1.
    urban=True: a junction grammar over the corridors — forks (one corridor
    end feeding two successor corridors), merges (two ends feeding one
    start), turn connectors marked is_intersection, and jittered lane
    widths — so the packed graphs populate the irregular cross-lane edge
    lists and dilated-scale scatter paths the way real Argoverse maps do
    (reference maps branch/merge at every intersection, data.py:220-361;
    lanes carry multiple successors/predecessors there)."""
    lanes, trajs, steps = _synthetic_world(seed, num_corridors, num_actors, num_hist,
                                           num_pred, urban)
    data = featurize_scenario(trajs, steps, num_hist, num_pred)

    # Build the graph in the agent frame (reference rotates centerlines into
    # the agent frame before graph construction, data.py:231).
    rot, orig = data["rot"], data["orig"]
    rot_lanes = [
        Lane(
            ln.id,
            np.matmul(rot, (ln.centerline - orig.reshape(-1, 2)).T).T,
            ln.predecessors,
            ln.successors,
            ln.left_neighbor,
            ln.right_neighbor,
            ln.turn_direction,
            ln.has_traffic_control,
            ln.is_intersection,
        )
        for ln in lanes
    ]
    data["graph"] = build_lane_graph(rot_lanes, num_scales=num_scales)
    # Submission identity (reference attaches argo_id/city, data.py:364-434).
    data["seq_id"] = int(seed)
    data["city"] = "SYN"
    return data


def make_urban_scenario(seed: int, num_corridors: int = 5, num_actors: int = 12, **kw) -> Dict:
    """Junction-rich scenario (forks/merges/turn connectors) — the
    benchmark-realistic counterpart of make_synthetic_scenario."""
    return make_synthetic_scenario(
        seed, num_corridors=num_corridors, num_actors=num_actors, urban=True, **kw
    )


def make_roi_scenario(seed: int, num_corridors: int = 4, num_actors: int = 12,
                      urban: bool = False) -> Dict:
    """A synthetic scenario with its per-agent LaneRoI subgraphs (LaneRCNN's
    input; the counterpart of the JAX package's RoiSyntheticDataset item)."""
    return generate_lane_rois(make_synthetic_scenario(
        seed, num_corridors=num_corridors, num_actors=num_actors, urban=urban))
