"""Argoverse v1.1 motion-forecasting data: CSV reader + map adapter, the
port's counterpart of lanegcn_tpu/data/argoverse.py.

- read_argo_csv: parse one scenario CSV into per-track trajectories grouped
  by (TRACK_ID, OBJECT_TYPE) with the AGENT first (the csv module and
  numpy: no pandas, whose semantics it reproduces, see its docstring),
- MapProvider protocol: lanes within a radius of a point, as
  lane_graph.Lane records (ArgoverseMapProvider wraps the argoverse-api map
  when it is installed),
- build_scenario / ArgoScenarioDataset: CSV dir + MapProvider → featurized
  scenario dicts through the same featurize_scenario/build_lane_graph
  pipeline as synthetic data; a PackedLoader takes the dataset as it is.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Protocol, Sequence

import numpy as np

from lanegcn_tpu_torch.data.featurize import featurize_scenario
from lanegcn_tpu_torch.data.lane_graph import Lane, build_lane_graph
from lanegcn_tpu_torch.data.lane_roi import generate_lane_rois

_INT = re.compile(r"[+-]?[0-9]+")


def read_argo_csv(path: str) -> Dict:
    """Parse a scenario CSV (TIMESTAMP, TRACK_ID, OBJECT_TYPE, X, Y and
    optionally CITY_NAME, found by header name): timestamps mapped to the
    indices of the sorted unique timestamps, tracks grouped by (TRACK_ID,
    OBJECT_TYPE) in sorted key order with the AGENT moved first, each
    track's rows in file order (reference read_argo_data data.py:107-146).

    The JAX reader's pandas semantics are kept: when every TRACK_ID is an
    integer the column is numeric and the keys sort as numbers ("9" before
    "10"), otherwise as strings; `city` is the first row's CITY_NAME, or ""
    without that column. Floats are parsed with Python's float(), which is
    correctly rounded (pandas' default parser can be off by an ulp or two).
    """
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    col = {name: i for i, name in enumerate(header)}
    ts = np.array([float(r[col["TIMESTAMP"]]) for r in rows], np.float64)
    trajs = np.array([[float(r[col["X"]]), float(r[col["Y"]])] for r in rows],
                     np.float64).reshape(-1, 2)
    steps = np.searchsorted(np.unique(ts), ts).astype(np.int64)

    ids = [r[col["TRACK_ID"]] for r in rows]
    if ids and all(_INT.fullmatch(t) for t in ids):
        ids = [int(t) for t in ids]
    groups: Dict[tuple, List[int]] = {}
    for i, key in enumerate(zip(ids, (r[col["OBJECT_TYPE"]] for r in rows))):
        groups.setdefault(key, []).append(i)
    keys = sorted(groups)
    agt_key = keys.pop([k[1] for k in keys].index("AGENT"))
    idcs = [np.asarray(groups[k], np.int64) for k in [agt_key] + keys]

    city = rows[0][col["CITY_NAME"]] if "CITY_NAME" in col else ""
    return {
        "city": city,
        "trajs": [trajs[i] for i in idcs],
        "steps": [steps[i] for i in idcs],
    }


class MapProvider(Protocol):
    def lanes_in_radius(self, center: np.ndarray, city: str, radius: float) -> List[Lane]:
        """Lane records (world frame) within radius of center."""
        ...


class ArgoverseMapProvider:
    """Adapter over the argoverse-api map (imported when constructed: an
    ImportError without the package; reference data.py:220-263 consumes the
    same fields)."""

    def __init__(self):
        from argoverse.map_representation.map_api import ArgoverseMap  # gated

        self.am = ArgoverseMap()

    def lanes_in_radius(self, center, city, radius):
        lane_ids = self.am.get_lane_ids_in_xy_bbox(center[0], center[1], city, radius)
        lanes = []
        for lid in lane_ids:
            ln = self.am.city_lane_centerlines_dict[city][lid]
            lanes.append(
                Lane(
                    lane_id=lid,
                    centerline=np.asarray(ln.centerline[:, :2], np.float32),
                    predecessors=ln.predecessors or [],
                    successors=ln.successors or [],
                    left_neighbor=ln.l_neighbor_id,
                    right_neighbor=ln.r_neighbor_id,
                    turn_direction=ln.turn_direction or "NONE",
                    has_traffic_control=bool(ln.has_traffic_control),
                    is_intersection=bool(ln.is_intersection),
                )
            )
        return lanes


def build_scenario(
    raw: Dict,
    map_provider: MapProvider,
    num_hist: int = 20,
    num_pred: int = 30,
    num_scales: int = 6,
    pred_range: Sequence[float] = (-100.0, 100.0, -100.0, 100.0),
    cross_dist: float = 6.0,
) -> Dict:
    """raw CSV dict + map → featurized scenario with agent-frame lane graph
    (reference ArgoDataset.__getitem__ raw path, data.py:84-99). The map is
    asked for lanes within max|x| + max|y| of pred_range around the agent;
    a lane whose agent-frame box misses the pred_range box is left out
    whole (data.py:230-241)."""
    data = featurize_scenario(
        raw["trajs"], raw["steps"], num_hist, num_pred, pred_range
    )
    x_min, x_max, y_min, y_max = pred_range
    radius = max(abs(x_min), abs(x_max)) + max(abs(y_min), abs(y_max))
    lanes = map_provider.lanes_in_radius(data["orig"], raw.get("city", ""), radius)

    rot, orig = data["rot"], data["orig"]
    clipped: List[Lane] = []
    for ln in lanes:
        cl = np.matmul(rot, (ln.centerline - orig.reshape(-1, 2)).T).T
        x, y = cl[:, 0], cl[:, 1]
        if x.max() < x_min or x.min() > x_max or y.max() < y_min or y.min() > y_max:
            continue
        clipped.append(
            Lane(
                ln.id, cl, ln.predecessors, ln.successors, ln.left_neighbor,
                ln.right_neighbor, ln.turn_direction, ln.has_traffic_control,
                ln.is_intersection,
            )
        )
    data["graph"] = build_lane_graph(clipped, num_scales=num_scales, cross_dist=cross_dist)
    data["city"] = raw.get("city", "")
    return data


class ArgoScenarioDataset:
    """Directory of scenario CSVs + a MapProvider → scenario dicts (a
    dataset for PackedLoader: __len__ and __getitem__)."""

    def __init__(
        self,
        csv_dir: str,
        map_provider: Optional[MapProvider] = None,
        num_scales: int = 6,
        with_rois: bool = False,
    ):
        self.paths = sorted(
            os.path.join(csv_dir, f) for f in os.listdir(csv_dir) if f.endswith(".csv")
        )
        self.map_provider = map_provider or ArgoverseMapProvider()
        self.num_scales = num_scales
        self.with_rois = with_rois

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict:
        raw = read_argo_csv(self.paths[idx])
        data = build_scenario(raw, self.map_provider, num_scales=self.num_scales)
        # Argoverse convention: the CSV filename stem is the sequence id
        # (reference ArgoTestDataset attaches argo_id, data.py:364-434).
        stem = os.path.splitext(os.path.basename(self.paths[idx]))[0]
        try:
            data["seq_id"] = int(stem)
        except ValueError:
            data["seq_id"] = idx
        if self.with_rois:
            data = generate_lane_rois(data)
        return data
