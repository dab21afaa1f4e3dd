"""Static-shape packed batches: the port's data layout.

Plain dataclasses with the same field names and properties as the JAX
package's pytrees (one packed micro-batch: all actors of all scenarios in
one [A, ...] buffer, all lane nodes in one [N, ...] buffer, fixed-capacity
edge lists with validity masks, window-pair chunked fusion plans).

The host packers (data/packing.py, data/packing_roi.py) fill them with
numpy arrays; `PackedBatch.from_numpy` and `RoiPackedBatch.from_numpy` turn
any object with these fields (the packer's output, or another framework's
pack with numpy leaves) into torch tensors, and `.to(device)` moves them.
Edge-list and row indices become int64 (torch indexing); the window plans,
pair plans and window-chunked edge fields keep int32, which is what the
CUDA kernels read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


def _convert(x, keep_int32: bool):
    """numpy / torch leaf → CPU torch tensor (int32 → int64 unless kept)."""
    if x is None:
        return None
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if t.dtype == torch.int32 and not keep_int32:
        t = t.long()
    return t


def _map_leaves(obj, fn):
    """Apply fn to every tensor / array leaf of a dataclass tree."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return {k: _map_leaves(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            kw[f.name] = _map_leaves(v, fn) if _is_node(v) else v
        return type(obj)(**kw)
    return fn(obj)


def _is_node(v) -> bool:
    return (
        v is None
        or isinstance(v, (dict, torch.Tensor, np.ndarray))
        or dataclasses.is_dataclass(v)
    )


class _Tree:
    """Shared `.to(device)`, `.map_leaves(fn)` and `.leaves()` for the batch
    dataclasses."""

    def to(self, device):
        return _map_leaves(self, lambda t: t.to(device))

    def map_leaves(self, fn):
        """A copy of the tree with fn applied to every tensor leaf."""
        return _map_leaves(self, fn)

    def leaves(self) -> list:
        """Every tensor leaf, in field order."""
        out = []
        _map_leaves(self, out.append)
        return out


@dataclasses.dataclass
class EdgeSet(_Tree):
    """Fixed-capacity directed edge list: messages flow v (source) → u (dest)."""

    u: torch.Tensor  # [E] destination row
    v: torch.Tensor  # [E] source row
    mask: torch.Tensor  # [E] bool, False on padding
    inv_perm: Optional[torch.Tensor] = None
    inv_dst: Optional[torch.Tensor] = None
    # Window-chunked layout (data/packing.py window_chunked_edges): each
    # destination window's edges fill whole 512-edge chunks, destination-
    # sorted, so a window's padding sits between its last edge and the next
    # window's first. win_lu [E, 1] int32 window-local destination (-1 on
    # padding), win_chunk / win_first [E/512] int32 the destination window
    # of each chunk and whether it is the window's first; win_stride the
    # destination window's rows.
    win_lu: Optional[torch.Tensor] = None
    win_chunk: Optional[torch.Tensor] = None
    win_first: Optional[torch.Tensor] = None
    win_stride: int = 0

    @property
    def capacity(self) -> int:
        return self.u.shape[0]

    @property
    def dst_sorted(self) -> bool:
        """True iff the packer emitted the list destination-sorted (u
        non-decreasing over the valid edges, padding last) with its
        source-side inverse: inv_perm is the argsort of v over the valid
        edges, inv_dst = v[inv_perm] with the source-row count as the
        padding sentinel. Window-chunked lists carry the inverse too, but
        their padding holes sit mid-array, so they are not."""
        return self.inv_perm is not None and self.win_lu is None

    def num_valid(self):
        return self.mask.sum()

    @classmethod
    def from_numpy(cls, e) -> "EdgeSet":
        return cls(
            u=_convert(e.u, False),
            v=_convert(e.v, False),
            mask=_convert(e.mask, False),
            inv_perm=_convert(getattr(e, "inv_perm", None), False),
            inv_dst=_convert(getattr(e, "inv_dst", None), False),
            win_lu=_convert(getattr(e, "win_lu", None), True),
            win_chunk=_convert(getattr(e, "win_chunk", None), True),
            win_first=_convert(getattr(e, "win_first", None), True),
            win_stride=int(getattr(e, "win_stride", 0)),
        )


@dataclasses.dataclass
class PairPlan(_Tree):
    """Window-pair chunked edge layout (the win_edge kernel's input).

    idx[:, 0] = window-local dst row, idx[:, 1] = window-local src row (-1
    padding), optional idx[:, 2] = relation id; meta rows = dwin, swin,
    first, sperm, sswin, sfirst over the NC chunks. Chunks are sorted by
    (dwin, swin), so each destination window's chunks form one run that
    starts where `first` is 1.
    """

    idx: torch.Tensor  # [NC*chunk, 2 or 3] int32
    meta: torch.Tensor  # [6, NC] int32
    chunk: int = 128
    dst_stride: int = 0
    src_stride: int = 0

    @property
    def lu(self):
        return self.idx[:, 0:1]

    @property
    def lv(self):
        return self.idx[:, 1:2]

    @property
    def rel(self):
        return self.idx[:, 2:3]

    @property
    def dwin(self):
        return self.meta[0]

    @property
    def swin(self):
        return self.meta[1]

    @property
    def first(self):
        return self.meta[2]

    @property
    def sperm(self):
        return self.meta[3]

    @property
    def sswin(self):
        return self.meta[4]

    @property
    def sfirst(self):
        return self.meta[5]

    @property
    def num_chunks(self) -> int:
        return self.meta.shape[1]

    def num_valid(self):
        return (self.idx[:, 0] >= 0).sum()

    @classmethod
    def from_numpy(cls, p) -> "PairPlan | None":
        if p is None:
            return None
        return cls(
            idx=_convert(p.idx, True).to(torch.int32),
            meta=_convert(p.meta, True).to(torch.int32),
            chunk=int(p.chunk),
            dst_stride=int(p.dst_stride),
            src_stride=int(p.src_stride),
        )


@dataclasses.dataclass
class ActorBatch(_Tree):
    """All actors of a pack, concatenated."""

    feats: torch.Tensor  # [A, T_hist, 3]
    ctrs: torch.Tensor  # [A, 2]
    mask: torch.Tensor  # [A] bool
    scen: torch.Tensor  # [A] scenario id within the pack

    @property
    def capacity(self) -> int:
        return self.feats.shape[0]

    @classmethod
    def from_numpy(cls, a) -> "ActorBatch":
        return cls(
            feats=_convert(a.feats, False),
            ctrs=_convert(a.ctrs, False),
            mask=_convert(a.mask, False),
            scen=_convert(a.scen, False),
        )


@dataclasses.dataclass
class LaneGraphBatch(_Tree):
    """All lane nodes + relation edges of a pack.

    bands[nm][u] ⇔ intra-lane edge (u, u + band_shift(nm)) exists; `edges`
    holds the residue lists; plan_lu/plan_lv/plan_rel are the window edge
    plan ([W*ECAP, 1] int32 window-local rows, -1 padding) over plan_scen
    windows. `tables[nm][u]` is the source row of u's neighbour in relation
    nm (>= N: none) and `table_inv` their combined inverse (the order of the
    table gather's backward, ops/scatter.py `table_order`); `spill_pair` is
    the window plan's residue as a
    (dst-window, src-window) chunk-pair plan with a relation column.
    """

    ctrs: torch.Tensor  # [N, 2]
    feats: torch.Tensor  # [N, 2]
    turn: torch.Tensor  # [N, 2]
    control: torch.Tensor  # [N]
    intersect: torch.Tensor  # [N]
    node_mask: torch.Tensor  # [N] bool
    node_scen: torch.Tensor  # [N]
    edges: Dict[str, EdgeSet]
    bands: Optional[Dict[str, torch.Tensor]] = None
    tables: Optional[Dict[str, torch.Tensor]] = None
    table_inv: Optional[EdgeSet] = None
    spill_pair: Optional[PairPlan] = None
    plan_lu: Optional[torch.Tensor] = None
    plan_lv: Optional[torch.Tensor] = None
    plan_rel: Optional[torch.Tensor] = None
    plan_scen: int = 0

    @property
    def capacity(self) -> int:
        return self.ctrs.shape[0]

    @classmethod
    def from_numpy(cls, g) -> "LaneGraphBatch":
        bands = getattr(g, "bands", None)
        tables = getattr(g, "tables", None)
        table_inv = getattr(g, "table_inv", None)
        return cls(
            ctrs=_convert(g.ctrs, False),
            feats=_convert(g.feats, False),
            turn=_convert(g.turn, False),
            control=_convert(g.control, False),
            intersect=_convert(g.intersect, False),
            node_mask=_convert(g.node_mask, False),
            node_scen=_convert(g.node_scen, False),
            edges={k: EdgeSet.from_numpy(e) for k, e in g.edges.items()},
            bands=None if bands is None else {
                k: _convert(m, False) for k, m in bands.items()},
            tables=None if tables is None else {
                k: _convert(t, False) for k, t in tables.items()},
            table_inv=None if table_inv is None else EdgeSet.from_numpy(table_inv),
            spill_pair=PairPlan.from_numpy(getattr(g, "spill_pair", None)),
            plan_lu=_convert(getattr(g, "plan_lu", None), True),
            plan_lv=_convert(getattr(g, "plan_lv", None), True),
            plan_rel=_convert(getattr(g, "plan_rel", None), True),
            plan_scen=int(getattr(g, "plan_scen", 0)),
        )


@dataclasses.dataclass
class FusionEdges(_Tree):
    """Distance-thresholded bipartite fusion edges (a2m, m2a, a2a) and their
    window-pair chunked plans."""

    a2m: EdgeSet
    m2a: EdgeSet
    a2a: EdgeSet
    pair_a2m: Optional[PairPlan] = None
    pair_m2a: Optional[PairPlan] = None
    pair_a2a: Optional[PairPlan] = None

    @classmethod
    def from_numpy(cls, f) -> "FusionEdges":
        return cls(
            a2m=EdgeSet.from_numpy(f.a2m),
            m2a=EdgeSet.from_numpy(f.m2a),
            a2a=EdgeSet.from_numpy(f.a2a),
            pair_a2m=PairPlan.from_numpy(getattr(f, "pair_a2m", None)),
            pair_m2a=PairPlan.from_numpy(getattr(f, "pair_m2a", None)),
            pair_a2a=PairPlan.from_numpy(getattr(f, "pair_a2a", None)),
        )


@dataclasses.dataclass
class PackedBatch(_Tree):
    """One device's micro-batch: the unit the model consumes."""

    actors: ActorBatch
    graph: LaneGraphBatch
    fusion: FusionEdges
    gt_preds: torch.Tensor  # [A, T_pred, 2]
    has_preds: torch.Tensor  # [A, T_pred] bool
    rot: torch.Tensor  # [B, 2, 2]
    orig: torch.Tensor  # [B, 2]
    scen_mask: torch.Tensor  # [B] bool
    agent_idx: torch.Tensor  # [B] packed row of each scenario's AGENT

    @property
    def num_scenarios(self) -> int:
        return self.rot.shape[0]

    @classmethod
    def from_numpy(cls, b) -> "PackedBatch":
        """Any pack with these fields and numpy (or torch) leaves → a
        PackedBatch of CPU tensors."""
        return cls(
            actors=ActorBatch.from_numpy(b.actors),
            graph=LaneGraphBatch.from_numpy(b.graph),
            fusion=FusionEdges.from_numpy(b.fusion),
            gt_preds=_convert(b.gt_preds, False),
            has_preds=_convert(b.has_preds, False),
            rot=_convert(b.rot, False),
            orig=_convert(b.orig, False),
            scen_mask=_convert(b.scen_mask, False),
            agent_idx=_convert(b.agent_idx, False),
        )


@dataclasses.dataclass
class RoiPackedBatch(_Tree):
    """LaneRCNN's pack: every RoI subgraph's nodes flattened RoI-major (the
    reference's subgraph_gather, reference lanercnn.py:122-231), the shared
    global lane graph, the RoI↔graph pool edges and the interest-RoI decode
    layout. Shapes: M RoI-node, R RoI, MI interest-node, B scenario and N
    global-node capacities, T history steps."""

    node_feats: torch.Tensor  # [M, 8] ctr, dir, turn, control, intersect
    node_mask: torch.Tensor  # [M] bool
    node_roi: torch.Tensor  # [M] RoI row
    agent_feat: torch.Tensor  # [R, 80] 20 x (traj xy, delta xy)
    agent_vel: torch.Tensor  # [R]
    roi_mask: torch.Tensor  # [R] bool
    roi_scen: torch.Tensor  # [R]
    edges: Dict[str, EdgeSet]  # relations within [M]
    a2m: EdgeSet  # u → RoI rows [R], v → RoI-node rows [M]
    graph: LaneGraphBatch  # the global lane graph
    r2g: EdgeSet  # u → global-node rows [N], v → RoI-node rows [M]
    g2r: EdgeSet  # u → RoI-node rows [M], v → global-node rows [N]
    int_node_idx: torch.Tensor  # [MI] RoI-node row
    int_node_scen: torch.Tensor  # [MI] scenario row
    int_node_mask: torch.Tensor  # [MI] bool
    a2r: EdgeSet  # u → interest-node rows [MI], v → trajectory-point rows [B*T]
    agt_ctrs: torch.Tensor  # [B, 2] focal agent, agent frame
    agt_dirs: torch.Tensor  # [B, 2] unit last-step heading (0 if still)
    agt_vels: torch.Tensor  # [B]
    agt_trajs: torch.Tensor  # [B, T, 2]
    agt_traj_dirs: torch.Tensor  # [B, T, 2]
    gt_preds: torch.Tensor  # [B, T_pred, 2]
    has_preds: torch.Tensor  # [B, T_pred] bool
    scen_mask: torch.Tensor  # [B] bool
    bands: Optional[Dict[str, torch.Tensor]] = None
    tables: Optional[Dict[str, torch.Tensor]] = None
    table_inv: Optional[EdgeSet] = None
    plan_lu: Optional[torch.Tensor] = None
    plan_lv: Optional[torch.Tensor] = None
    plan_rel: Optional[torch.Tensor] = None
    plan_scen: int = 0

    @property
    def num_scenarios(self) -> int:
        return self.scen_mask.shape[0]

    @classmethod
    def from_numpy(cls, b) -> "RoiPackedBatch":
        """Any RoI pack with these fields and numpy (or torch) leaves → a
        RoiPackedBatch of CPU tensors."""
        bands = getattr(b, "bands", None)
        tables = getattr(b, "tables", None)
        table_inv = getattr(b, "table_inv", None)
        plain = {f: _convert(getattr(b, f), False) for f in (
            "node_feats", "node_mask", "node_roi", "agent_feat", "agent_vel", "roi_mask",
            "roi_scen", "int_node_idx", "int_node_scen", "int_node_mask", "agt_ctrs",
            "agt_dirs", "agt_vels", "agt_trajs", "agt_traj_dirs", "gt_preds", "has_preds",
            "scen_mask")}
        return cls(
            **plain,
            edges={k: EdgeSet.from_numpy(e) for k, e in b.edges.items()},
            a2m=EdgeSet.from_numpy(b.a2m),
            graph=LaneGraphBatch.from_numpy(b.graph),
            r2g=EdgeSet.from_numpy(b.r2g),
            g2r=EdgeSet.from_numpy(b.g2r),
            a2r=EdgeSet.from_numpy(b.a2r),
            bands=None if bands is None else {k: _convert(m, False) for k, m in bands.items()},
            tables=None if tables is None else {
                k: _convert(t, False) for k, t in tables.items()},
            table_inv=None if table_inv is None else EdgeSet.from_numpy(table_inv),
            plan_lu=_convert(getattr(b, "plan_lu", None), True),
            plan_lv=_convert(getattr(b, "plan_lv", None), True),
            plan_rel=_convert(getattr(b, "plan_rel", None), True),
            plan_scen=int(getattr(b, "plan_scen", 0)),
        )
