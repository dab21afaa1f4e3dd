"""MapNet + the LaneConv stack (reference lanegcn.py:266-363, 410-480).

Per node u and layer:

    temp[u] = W_ctr x[u] + Σ_{r ∈ pre0..5, suc0..5, left, right} Σ_{(u,v) ∈ E_r} W_r x[v]
    x' = relu(GN(temp));  x'' = relu(Linear(x') + res)

The port runs the JAX package's formulation, in its order, for whatever
the pack carries:
- the intra-lane band edges (v = u + 2^s, the pack's band masks): in the
  unfused layer (`ModelConfig(pallas_bands="off")`) the `band_conv` kernel
  adds them into temp; in the fused one, the layer kernel below;
- the neighbour tables (left/right of the contiguous layout): one stacked
  row gather (`masked_gather`, which computes what the JAX package's
  `stacked_table_gather` does) and one relation-contracting einsum;
- the residue lists: one masked_gather of all relations' lists →
  per-relation matmul → one scatter_add, both in an order sorted once per
  call (ops/scatter.py) and shared by the layers;
- the window plan's edges (both endpoints in one node window), on the
  plan prepared once per call and shared by the layers: the
  `scenario_agg` kernel, or, in the fused layer with
  `ModelConfig.merge_plan_agg` and a node window that can be the layer's
  tile (`merge_plan`), inside the layer kernel (`lane_plan`); a plan that
  is not group-aligned raises (`check_plan_groups`) instead of losing
  edges;
- the spill plan (the window plan's residue as (dst-window, src-window)
  chunk pairs): the `pair_agg` kernel, forward and backward on the plan
  prepared once (`prepare_spill`, with the source order when a gradient is
  wanted): by LaneGCN for MapNet's and M2M's stacks (`graph_spill`), else
  by the stack once per call, and shared by the layers;
- the layer tail relu(GN(temp)) → Linear → + res → relu: in the fused
  layer (`pallas_bands` "auto", "on" or "interpret", with band masks) the
  `lane_layer` kernel computes the band products and the tail together
  (`lane_plan` when merged); in the unfused layer (`pallas_bands="off"`,
  or a pack without band masks, `split_bands=False`) the `row_tail` kernel
  computes the tail.

One stack serves every node space: MapNet's and M2M's lane graph, and
LaneRCNN's RoI subgraphs and global graph (the stack takes the relation
fields, not a pack). Both layers hold the same parameters, so one state
dict loads into either.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from lanegcn_tpu_torch.config import ModelConfig, band_shift, relation_names
from lanegcn_tpu_torch.graph import EdgeSet, LaneGraphBatch, PairPlan
from lanegcn_tpu_torch.models.layers import Dense, GroupNorm, Linear
from lanegcn_tpu_torch.ops.band_conv import band_conv
from lanegcn_tpu_torch.ops.lane_layer import fused_lane_layer, fused_lane_layer_plan
from lanegcn_tpu_torch.ops.pair_agg import pair_aggregate, prepare_spill
from lanegcn_tpu_torch.ops.row_tail import fused_row_tail
from lanegcn_tpu_torch.ops.scatter import masked_gather, order_by, scatter_add, table_order
from lanegcn_tpu_torch.ops.scenario_agg import _CHUNK as PLAN_CHUNK
from lanegcn_tpu_torch.ops.scenario_agg import (GROUPED_MIN_CAP, PlanPrep, plan_applied,
                                                 prepare_plan, scenario_aggregate)


class LaneConvStack(nn.ModuleDict):
    """num_layers residual LaneConv blocks. The module IS the reference's
    `fuse` ModuleDict (ctr, pre0..5, suc0..5, left, right, norm, ctr2 — one
    entry per layer each), so its parameter names match the reference."""

    def __init__(self, cfg: ModelConfig, num_layers: int = 4,
                 dtype: torch.dtype = torch.float32):
        c = cfg.n_map
        names = relation_names(cfg.num_scales)
        dense = lambda: nn.ModuleList(
            [Dense(c, c, bias=False, dtype=dtype) for _ in range(num_layers)])
        blocks = {"ctr": dense()}
        blocks.update({name: dense() for name in names})
        blocks["norm"] = nn.ModuleList([GroupNorm(c) for _ in range(num_layers)])
        blocks["ctr2"] = nn.ModuleList(
            [Linear(c, c, act=False, dtype=dtype) for _ in range(num_layers)])
        super().__init__(blocks)
        self.cfg = cfg
        self.num_layers = num_layers
        self.dtype = dtype
        self.names = names

    def forward(self, feat: torch.Tensor, edges: Dict[str, EdgeSet],
                bands: Dict[str, torch.Tensor] | None,
                tables: Dict[str, torch.Tensor] | None = None,
                plan: Tuple | None = None, spill: PairPlan | None = None,
                table_inv: EdgeSet | None = None,
                spill_prep: PlanPrep | None = None) -> torch.Tensor:
        """feat [N, C] over one node space and that space's relations: the
        residue lists `edges`, the band masks, the neighbour tables (with
        their inverse `table_inv`, when the pack has one), the window plan
        (lu, lv, rel, windows) and the spill plan, as a pack carries them
        (`graph_inputs` for a LaneGraphBatch); `spill_prep`: the spill plan
        prepared for these N rows (`graph_spill`), or None to prepare it
        here."""
        dt = self.dtype
        fuse = self
        names = self.names
        num_nodes = feat.shape[0]
        band_rel = [(r, nm) for r, nm in enumerate(names) if bands and nm in bands]
        shifts = [band_shift(nm) for _, nm in band_rel]
        band_idx = [r for r, _ in band_rel]
        if band_rel:
            band_masks = torch.stack([bands[nm] for _, nm in band_rel], 0).contiguous()
        fused = bool(band_rel) and self.cfg.pallas_bands != "off"
        grad = torch.is_grad_enabled()

        groups, merge, prep = None, False, None
        if plan is not None:
            plan_lu, plan_lv, plan_rel, num_win = plan
            groups = plan_groups(names, plan_lu.shape[0] // num_win)
            check_plan_groups(plan_lu, plan_rel, num_win, groups, len(names))
            merge = fused and merge_plan(self.cfg, num_nodes, plan_lu.shape[0], num_win)
            # The plan's tiles and orders, shared by the layers' scenario_agg
            # or lane_plan kernels and their backwards.
            prep = prepare_plan(plan_lu, plan_lv, plan_rel, num_win, num_nodes // num_win,
                                groups, len(names), backward=grad)

        if spill is not None and spill_prep is None:  # pair_agg's tiles and orders
            spill_prep = prepare_spill(spill, num_nodes, len(names), backward=grad)

        tbl_rel = [r for r, nm in enumerate(names) if tables and nm in tables]
        if tbl_rel:
            tbl_stack = torch.stack([tables[names[r]] for r in tbl_rel], 0)
            tbl_mask = tbl_stack < num_nodes
            tbl_order = None
            if grad:  # the gathers' backward: the pack's inverse, else one sort
                tbl_order = (table_order(table_inv, len(tbl_rel), num_nodes)
                             if table_inv is not None
                             else order_by(tbl_stack, tbl_mask, num_nodes))
        # The residue lists of all relations as one list, in destination
        # order for the scatter and (when training) in source order for the
        # gather's backward: one sort each per call, shared by the layers.
        caps = [edges[nm].u.shape[0] for nm in names]
        edge_u = torch.cat([edges[nm].u for nm in names])
        edge_v = torch.cat([edges[nm].v for nm in names])
        edge_m = torch.cat([edges[nm].mask for nm in names])
        dst = order_by(edge_u, edge_m, num_nodes)
        src = order_by(edge_v, edge_m, num_nodes) if grad else None

        for i in range(self.num_layers):
            temp = fuse["ctr"][i](feat)
            # Stacked relation kernel [R, C, C] in (in, out) layout.
            w_rel = torch.stack([fuse[nm][i].kernel for nm in names], 0)
            w_dt = w_rel.to(dt).contiguous()
            if band_rel and not fused:
                temp = temp + band_conv(feat.to(dt).contiguous(), band_masks,
                                        w_dt[band_idx].contiguous(), shifts)
            if tbl_rel:
                # temp[u] += Σ_r feat[tables[r, u]] @ W_r over the tabled relations.
                xg = masked_gather(feat, tbl_stack, tbl_mask, tbl_order)
                temp = temp + torch.einsum("rnc,rcd->nd", xg.to(dt), w_rel[tbl_rel].to(dt))
            rows = masked_gather(feat, edge_v, edge_m, src).to(dt).split(caps)
            msgs = torch.cat([x @ w_rel[r].to(dt) for r, x in enumerate(rows)])
            temp = scatter_add(msgs, edge_u, num_nodes, mask=edge_m, out=temp, order=dst)
            if plan is not None and not merge:
                temp = scenario_aggregate(
                    feat.to(dt).contiguous(), temp.to(dt).contiguous(), w_dt,
                    plan_lu, plan_lv, plan_rel, num_win, groups, prep,
                )
            if spill is not None:
                temp = pair_aggregate(feat.to(dt).contiguous(), temp.to(dt).contiguous(), w_dt,
                                      spill, spill_prep)
            norm, ctr2 = fuse["norm"][i], fuse["ctr2"][i]
            if fused:
                layer = (feat.to(dt).contiguous(), temp.to(dt).contiguous(), band_masks,
                         w_dt[band_idx].contiguous(), ctr2.linear.kernel.to(dt).contiguous(),
                         norm.weight, norm.bias, ctr2.norm.weight, ctr2.norm.bias)
                if merge:
                    feat = fused_lane_layer_plan(*layer, w_dt, plan_lu, plan_lv, plan_rel,
                                                 num_win, shifts, groups, norm.eps, prep)
                else:
                    feat = fused_lane_layer(*layer, shifts)
            else:
                feat = self.row_tail(i, temp, feat)
        return feat

    def row_tail(self, i: int, temp: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        """Layer i's tail relu(GN(temp)) → Linear → GN → + feat → relu, in
        the `row_tail` kernel (the unfused layer's)."""
        dt = self.dtype
        norm, ctr2 = self["norm"][i], self["ctr2"][i]
        return fused_row_tail(temp.to(dt).contiguous(), feat.to(dt).contiguous(),
                              ctr2.linear.kernel, norm.weight, norm.bias,
                              ctr2.norm.weight, ctr2.norm.bias)


def plan_groups(names, ecap: int):
    """The window plan's relation groups: (left/right, the dilated ones) when
    the plan is built grouped (ecap ≥ GROUPED_MIN_CAP, the packer's rule),
    else None (one group)."""
    lr = tuple(r for r, nm in enumerate(names) if nm in ("left", "right"))
    dil = tuple(r for r, nm in enumerate(names) if nm not in ("left", "right"))
    return (lr, dil) if ecap >= GROUPED_MIN_CAP and lr and dil else None


def check_plan_groups(lu, rel, num_win: int, groups, num_rel: int) -> None:
    """Raise if a valid plan slot lies outside its relation group's chunks
    (or past the last visited chunk): the plan kernels would drop it without
    a word. torch._assert_async: no host sync on the card, an immediate
    error on the CPU."""
    dropped = (lu.reshape(-1) >= 0) & ~plan_applied(lu, rel, num_win, groups, num_rel)
    torch._assert_async(~dropped.any(), "window plan is not group-aligned: valid slots lie "
                        "outside their relation group's chunks and would be dropped")


def merge_plan(cfg: ModelConfig, num_nodes: int, plan_slots: int, num_win: int) -> bool:
    """Whether the window plan runs inside the layer kernel
    (`fused_lane_layer_plan`), when the layer is the fused one: the config
    asks for it and the node tile can be the window stride (the JAX
    package's gate, models/map_net.py)."""
    stride = num_nodes // num_win
    return (cfg.merge_plan_agg != "off" and num_nodes % num_win == 0 and stride % 128 == 0
            and stride >= 512 and plan_slots % num_win == 0
            and (plan_slots // num_win) % PLAN_CHUNK == 0)


def graph_spill(graph, num_rel: int) -> PlanPrep | None:
    """The graph's spill plan prepared for pair_agg over its node rows (with
    the source order when a gradient is wanted), once for every LaneConv
    stack over that graph; None without a spill plan."""
    if graph.spill_pair is None:
        return None
    return prepare_spill(graph.spill_pair, graph.ctrs.shape[0], num_rel,
                         backward=torch.is_grad_enabled())


def graph_inputs(graph) -> dict:
    """A LaneConvStack's relation inputs from a LaneGraphBatch (the LaneGCN
    pack's graph, or LaneRCNN's global graph)."""
    plan = None
    if graph.plan_lu is not None:
        plan = (graph.plan_lu, graph.plan_lv, graph.plan_rel, graph.plan_scen)
    return dict(edges=graph.edges, bands=graph.bands, tables=graph.tables, plan=plan,
                spill=graph.spill_pair, table_inv=graph.table_inv)


class MapNet(nn.Module):
    """Lane-node embedding + LaneConv stack (reference lanegcn.py:266-363)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg.n_map
        self.input = nn.Sequential(Dense(2, c, dtype=dtype), nn.ReLU(),
                                   Linear(c, c, act=False, dtype=dtype))
        self.seg = nn.Sequential(Dense(2, c, dtype=dtype), nn.ReLU(),
                                 Linear(c, c, act=False, dtype=dtype))
        self.fuse = LaneConvStack(cfg, cfg.num_fuse_layers, dtype=dtype)

    def forward(self, graph: LaneGraphBatch, spill_prep: PlanPrep | None = None) -> torch.Tensor:
        feat = torch.relu(self.input(graph.ctrs) + self.seg(graph.feats))
        return self.fuse(feat, **graph_inputs(graph), spill_prep=spill_prep)
