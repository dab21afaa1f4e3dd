"""Explicit graph-parallel training of LaneGCN and LaneRCNN on
torch.distributed (`--graph-parallel explicit`): the port's counterpart of
lanegcn_tpu/parallel/graph_parallel.py.

Layout (mesh.py): rank r sits at data row d = r // G and graph column
g = r % G. Every rank of a data row holds that row's whole flat pack
(pack_batch(split_bands=False, split_tables=False, scenario_plan=False);
LaneRCNN's pack_roi_batch(split_bands=False, split_tables=False)) and only
its own column's edge lists: `partition_pack_edges` and
`partition_roi_pack_edges` split each list on the host, in the loader's
pack threads, by the owner of its source row (LaneRCNN's a2m by its
destination, the RoI-node row, so that its scatter is local). Rank g
computes on rows [g·n, (g+1)·n) of each node space (lane nodes, actors,
RoI nodes, global nodes) with the layers of graph_shard.py, on the
one-card modules and kernels.

Collectives of a forward: LaneGCN 14 reduce-scatters (8 LaneConv layers,
6 Att) and 7 all-gathers (6 Att queries, the outputs); LaneRCNN 14
reduce-scatters (12 LaneConv layers, 2 LanePoolings) and 1 all-gather (the
RoI features, before the replicated Decode). The backward issues the same
with the kinds swapped. Every rank takes the unchanged loss on the
gathered outputs and the whole pack; the gradient is all-reduced over the
D·G ranks and divided by D·G, which cancels the factor G the gathers'
backward puts in each rank's gradient (the JAX pmean over "graph", then
"data"); the loss is averaged over the data column and the other metrics
summed (WindowedComm's reductions).

The JAX package sizes the actor space of its partition as max_actors ×
max_scenarios (graph_parallel.py:115), while the pack holds max_actors
rows: at G > 1 it puts every actor-sourced edge (a2m, a2a) on the first
ranks with local rows past their block. The port partitions each space by
the pack's own row count.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lanegcn_tpu_torch.config import Config, relation_names
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
from lanegcn_tpu_torch.graph import EdgeSet, ShardedPack
from lanegcn_tpu_torch.ops.scatter import masked_gather, order_by, scatter_add
from lanegcn_tpu_torch.parallel.graph_shard import (
    att_sharded,
    fusion_lists,
    lane_conv_stack_sharded,
    local_rows,
    own_rows,
    partition_one,
    relation_lists,
)
from lanegcn_tpu_torch.parallel.mesh import Mesh, gather_union, reduce_scatter_rows
from lanegcn_tpu_torch.parallel.windowed_parallel import WindowedComm
from lanegcn_tpu_torch.train.loop import make_train_step


def shard_edge_capacity(capacity: int, num_shards: int, slack: float = 2.0) -> int:
    """A shard's static edge capacity: E/G with skew slack, 128-aligned, at
    most E."""
    return min(capacity, 128 * -(-int(np.ceil(capacity / num_shards * slack)) // 128))


class _Partitioner:
    """Partitions edge lists at one slack and sums their drops."""

    def __init__(self, num_shards: int, slack: float):
        self.num_shards, self.slack, self.dropped = num_shards, slack, 0

    def __call__(self, e, n_src: int) -> EdgeSet:
        """e split by the owner of v among n_src rows."""
        cap = shard_edge_capacity(np.asarray(e.u).shape[-1], self.num_shards, self.slack)
        su, sv, sm, dropped = partition_one(e.u, e.v, e.mask, n_src, self.num_shards, cap)
        self.dropped += dropped
        return EdgeSet(u=su, v=sv, mask=sm)


def partition_pack_edges(batch, config: Config, num_shards: int, slack: float = 2.0) -> Dict:
    """Host side: one flat LaneGCN pack's edges split by source shard:
    {"graph": {relation: EdgeSet}, "a2m", "m2a", "a2a"} with leading axes
    [G, cap] (shard_edge_capacity of each list's capacity), plus
    "dropped_edges". Sources: the relations and m2a on lane-node rows, a2m
    and a2a on actor rows (the pack's own counts)."""
    part = _Partitioner(num_shards, slack)
    n_nodes, n_actors = batch.graph.ctrs.shape[0], batch.actors.ctrs.shape[0]
    fus = batch.fusion
    out: Dict = {"graph": {nm: part(batch.graph.edges[nm], n_nodes)
                           for nm in relation_names(config.model.num_scales)}}
    out.update(a2m=part(fus.a2m, n_actors), m2a=part(fus.m2a, n_nodes),
               a2a=part(fus.a2a, n_actors))
    out["dropped_edges"] = part.dropped
    return out


def partition_roi_pack_edges(batch, config: Config, num_shards: int,
                             slack: float = 2.0) -> Dict:
    """Host side: one flat RoI pack's edges split for the explicit step:
    {"roi": {relation: EdgeSet}, "global": {...}, "a2m", "r2g", "g2r"} with
    leading axes [G, cap], plus "dropped_edges". Each list is split by its
    v row: the source for the RoI relations and r2g (RoI-node rows), the
    global relations and g2r (global-node rows); for a2m, whose sources u
    are the small replicated RoI (agent) rows, v is the destination
    RoI-node row, so its scatter is local and needs no collective. a2r
    stays whole: Decode runs replicated."""
    part = _Partitioner(num_shards, slack)
    m_cap, n_cap = batch.node_feats.shape[0], batch.graph.ctrs.shape[0]
    out: Dict = {"roi": {nm: part(e, m_cap) for nm, e in batch.edges.items()},
                 "global": {nm: part(e, n_cap) for nm, e in batch.graph.edges.items()}}
    out.update(a2m=part(batch.a2m, m_cap), r2g=part(batch.r2g, m_cap),
               g2r=part(batch.g2r, n_cap))
    out["dropped_edges"] = part.dropped
    return out


def column_edges(parts: Dict, g: int) -> Dict:
    """Graph column g's row of a partition (its "dropped_edges" left out)."""

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        return EdgeSet(u=x.u[g], v=x.v[g], mask=x.mask[g])

    return {k: take(v) for k, v in parts.items() if k != "dropped_edges"}


def explicit_packer(family: str, num_shards: int, column: int, slack: float = 2.0):
    """The loader's packer of graph column `column`: fn(scenarios, config) →
    (ShardedPack with numpy leaves, stats): the flat pack and this
    column's partitioned edges; stats["dropped_shard_edges"] counts what
    the partition dropped over the shards' capacities."""

    def pack(scens, cfg):
        if family == "lanercnn":
            b, stats = pack_roi_batch(scens, cfg.roi_pack, cfg.model, split_bands=False,
                                      split_tables=False)
            parts = partition_roi_pack_edges(b, cfg, num_shards, slack)
        else:
            b, stats = pack_batch(scens, cfg.pack, cfg.model, split_bands=False,
                                  split_tables=False, scenario_plan=False)
            parts = partition_pack_edges(b, cfg, num_shards, slack)
        stats["dropped_shard_edges"] = parts["dropped_edges"]
        return ShardedPack(pack=b, edges=column_edges(parts, column)), stats

    return pack


def check_explicit_capacities(config: Config, family: str, num_shards: int) -> None:
    """Raise unless every node space of the family's pack splits into
    num_shards equal row blocks (LaneGCN: lane nodes and actors; LaneRCNN:
    RoI nodes and global nodes). The kernels take a block of any row count
    (the row tails, edge chains and segment sums are held at 1, 63 and 65
    rows); at 128 channels every block starts 16-byte aligned."""
    if family == "lanercnn":
        rp = config.roi_pack
        spaces = {"max_roi_nodes": rp.max_roi_nodes,
                  "max_global_nodes": rp.max_global_nodes or rp.max_roi_nodes}
    else:
        spaces = {"max_nodes": config.pack.max_nodes, "max_actors": config.pack.max_actors}
    bad = {k: v for k, v in spaces.items() if v % num_shards}
    if bad:
        raise ValueError(f"--graph-parallel explicit splits each node space into {num_shards} "
                         f"row blocks; these capacities do not divide: {bad}")


def lanegcn_forward(net, batch, edges: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """LaneGCN.forward on this rank's rows of its data row's flat pack
    (`edges`: its column's partitioned edges): the gathered outputs cls
    [A, K] and reg [A, K, T, 2] (world frame), fp32, on every rank."""
    dt = net.dtype
    g = batch.graph
    n_nodes, n_act = g.ctrs.shape[0], batch.actors.ctrs.shape[0]
    rows = lambda x: local_rows(x, mesh)  # noqa: E731
    actor_ctrs = rows(batch.actors.ctrs)
    node_ctrs = rows(g.ctrs)
    actors = net.actor_net(rows(batch.actors.feats).to(dt))
    mp = net.map_net
    nodes = torch.relu(mp.input(node_ctrs) + mp.seg(rows(g.feats)))
    # The relations' orders, once for MapNet's and M2M's stacks.
    lane = relation_lists(edges["graph"], mp.fuse.names, nodes.shape[0], n_nodes)
    nodes = lane_conv_stack_sharded(mp.fuse, nodes, lane, n_nodes, mesh)
    meta = torch.cat([rows(g.turn), rows(g.control)[:, None], rows(g.intersect)[:, None]], -1)
    nodes = net.a2m.meta(torch.cat([nodes, meta.to(nodes.dtype)], -1))
    lists = fusion_lists(edges["a2m"], n_nodes, actors.shape[0])
    for att in net.a2m.att:
        nodes = att_sharded(att, nodes, g.ctrs, actors, actor_ctrs, lists, mesh)
    nodes = lane_conv_stack_sharded(net.m2m.fuse, nodes, lane, n_nodes, mesh)
    lists = fusion_lists(edges["m2a"], n_act, nodes.shape[0])
    for att in net.m2a.att:
        actors = att_sharded(att, actors, batch.actors.ctrs, nodes, node_ctrs, lists, mesh)
    lists = fusion_lists(edges["a2a"], n_act, actors.shape[0])
    for att in net.a2a.att:
        actors = att_sharded(att, actors, batch.actors.ctrs, actors, actor_ctrs, lists, mesh)
    cls, reg = net.pred_net(actors, actor_ctrs)
    scen = rows(batch.actors.scen)
    reg = torch.einsum("aktc,acd->aktd", reg.float(), batch.rot[scen]) + \
        batch.orig[scen][:, None, None, :]
    # One gather of both outputs, its backward one reduce-scatter.
    a, k = cls.shape
    both = gather_union(torch.cat([cls.float(), reg.reshape(a, -1)], 1), mesh)
    return {"cls": both[:, :k].contiguous(),
            "reg": both[:, k:].reshape((-1,) + tuple(reg.shape[1:])).contiguous()}


def pool_sharded(pool, ctx_local, ctx_pose_local, tgt_local, tgt_pose, edges: EdgeSet,
                 mesh: Mesh) -> torch.Tensor:
    """One LanePooling (models.lanercnn.LanePooling, flat edges) with its
    context and target rows split over the graph row (tgt_pose whole),
    `edges` this rank's, split by context row: the edge chain, the scatter
    into every target row (from the rank's own input term, as
    graph_shard's layers), then one reduce-scatter."""
    by_src = order_by(edges.v, edges.mask, ctx_local.shape[0]) if torch.is_grad_enabled() \
        else None
    num_tgt = tgt_pose.shape[0]
    partial = scatter_add(pool.messages(ctx_local, ctx_pose_local, tgt_pose, edges, by_src),
                          edges.u, num_tgt, mask=edges.mask,
                          out=own_rows(pool.input(tgt_local), num_tgt, mesh),
                          order=order_by(edges.u, edges.mask, num_tgt))
    return pool.tail(reduce_scatter_rows(partial, mesh), tgt_local)


def lanercnn_forward(net, batch, edges: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """LaneRCNN.forward on this rank's RoI-node and global-node rows of its
    data row's flat RoI pack; Decode runs on every rank on the gathered RoI
    features. The outputs (whole, fp32) on every rank."""
    rows = lambda x: local_rows(x, mesh)  # noqa: E731
    m_cap, n_cap = batch.node_feats.shape[0], batch.graph.ctrs.shape[0]
    # LaneInput: the a2m scatter lands on this rank's RoI-node rows (its
    # edges are split by destination).
    inp = net.input
    nf = rows(batch.node_feats)
    feat = inp.map_fc(nf)
    agt = inp.agt_fc(batch.agent_feat)
    ea = edges["a2m"]
    msg = masked_gather(agt, ea.u, ea.mask, order_by(ea.u, ea.mask, agt.shape[0]))
    feat = torch.relu(inp.bn(scatter_add(msg, ea.v, nf.shape[0], mask=ea.mask, out=feat)))
    roi = relation_lists(edges["roi"], net.roi_net1.fuse.names, nf.shape[0], m_cap)
    feat = lane_conv_stack_sharded(net.roi_net1.fuse, net.roi_net1.input(feat), roi, m_cap, mesh)

    it = net.interactor
    g = batch.graph
    g_ctrs, g_feats = rows(g.ctrs), rows(g.feats)
    graph_feat = torch.relu(it.input(g_ctrs) + it.seg(g_feats))
    graph_pose = torch.cat([g.ctrs, g.feats], -1)
    graph_feat = pool_sharded(it.roi2graph, feat, nf[:, :4], graph_feat, graph_pose,
                              edges["r2g"], mesh)
    stack = it.global_graph_net["fuse"]
    glob = relation_lists(edges["global"], stack.names, graph_feat.shape[0], n_cap)
    graph_feat = lane_conv_stack_sharded(stack, graph_feat, glob, n_cap, mesh)
    feat = pool_sharded(it.graph2roi, graph_feat, torch.cat([g_ctrs, g_feats], -1), feat,
                        batch.node_feats[:, :4], edges["g2r"], mesh)
    feat = lane_conv_stack_sharded(net.roi_net2.fuse, net.roi_net2.input(feat), roi, m_cap, mesh)
    logits, goals, trajs = net.decode(gather_union(feat, mesh), batch)
    return {"pred_logics": logits.float(), "pred_goals": goals.float(),
            "pred_trajs": trajs.float()}


class ExplicitComm(WindowedComm):
    """The explicit step's collectives outside the forward: every rank holds
    the whole pack and the forward returns the gathered outputs, so the
    union is the outputs and the pack as they are; the metrics' and the
    gradient's reductions are WindowedComm's."""

    def union(self, out, batch: ShardedPack):
        return out, batch.pack


def make_explicit_parallel_train_step(config: Config, net, state, mesh: Mesh, device=None,
                                      loss_fn=None, metrics_fn=None):
    """One rank's step of the explicit D×G split: fn(sharded_pack, epoch) →
    metrics. sharded_pack (a ShardedPack, e.g. from `explicit_packer`)
    holds its data row's whole flat pack and this rank's column of its
    edges. The loss and metrics equal the single-device step's on that pack
    (the loss averaged over the D rows, the rest summed), and the update is
    the single-device update on the mean of the D rows' gradients; net and
    state must start equal on every rank. LaneGCN or LaneRCNN by net.family
    (LaneRCNN: see make_explicit_parallel_roi_train_step for the loss)."""
    fwd = lanercnn_forward if net.family == "lanercnn" else lanegcn_forward
    return make_train_step(config, net, state, device=device or mesh.device, loss_fn=loss_fn,
                           metrics_fn=metrics_fn, comm=ExplicitComm(mesh),
                           forward=lambda b: fwd(net, b.pack, b.edges, mesh))


def make_explicit_parallel_roi_train_step(config: Config, net, state, mesh: Mesh, device=None,
                                          loss_fn=None, metrics_fn=None):
    """LaneRCNN's explicit step; loss_fn and metrics_fn default to roi_loss
    and roi_metrics."""
    from lanegcn_tpu_torch.models.lanercnn import roi_loss, roi_metrics

    return make_explicit_parallel_train_step(config, net, state, mesh, device,
                                             loss_fn or roi_loss, metrics_fn or roi_metrics)
