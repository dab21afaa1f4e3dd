"""Windowed (scenario-aligned) data×graph parallel training on
torch.distributed, the port's counterpart of
lanegcn_tpu/parallel/windowed_parallel.py.

Every LaneGCN and LaneRCNN edge relation is scenario-local, so cutting a
pack's scenarios into G groups makes every edge local to one group. Each
rank of a graph row packs its group at 1/G of every capacity
(`subdivide_pack_config`, `subdivide_roi_pack_config`; the groups balanced
by `balance_scenarios`) and runs the unchanged single-device model, and
its hand-written kernels, on that sub-pack. The only communication is:

  - one gather of the outputs and one of the loss-side pack fields over the
    graph row, so the loss is taken on the union of the row's sub-packs
    with the pack-joint normalization of one pack on one device;
  - in the backward, the gather's cotangent summed over the graph row
    (mesh.gather_union);
  - one all_reduce of the step's metrics over the data column (the loss
    averaged, the rest summed) and one of the flat gradient over every
    rank, divided by D·G: the JAX step's pmean over "graph" (which cancels
    the factor G that the gather's backward puts in each rank's gradient)
    then over "data".

Data parallel (`make_parallel_train_step`, lanegcn_tpu/parallel/
sharding.py:85) is the case G = 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple

import torch
import torch.distributed as dist

from lanegcn_tpu_torch.config import Config, PackConfig, RoiPackConfig
from lanegcn_tpu_torch.ops.window_scatter import WCHUNK
from lanegcn_tpu_torch.parallel.mesh import Mesh, all_gather_rows, gather_union
from lanegcn_tpu_torch.train.loop import make_train_step

# Chunks of alignment slack each sub-pack's pool edges get (see
# subdivide_roi_pack_config).
POOL_SLACK_CHUNKS = 4
# Headroom of the mesh's sub-packs over 1/G of the whole pack's capacities
# (`graph_split`), by family. The balanced split evens out one weight, not
# each capacity: at 1/G, draws of 256 urban scenarios split 4 ways skipped
# a LaneGCN scenario (bench and windowed: a part's node windows ran out),
# and LaneRCNN's split 2 and 4 ways skipped scenarios (RoI nodes to 14 %
# over 1/G) and dropped pool and global-graph edges (mesh_draws.py); the
# JAX package's formula has no headroom.
SPLIT_HEADROOM = {"lanegcn": 0.125, "lanercnn": 0.25}


def scenario_weight(scen) -> int:
    """Packing weight of one scenario: lane nodes + graph edges + actors
    (the three capacity families the sub-packs divide by G). RoI scenarios
    also count their RoI subgraph nodes: the pool-edge and RoI-node
    capacities are the tight ones there."""
    g = scen.get("graph") or {}
    ctrs = g.get("ctrs")
    nodes = int(g["num_nodes"]) if "num_nodes" in g else (
        len(ctrs) if ctrs is not None else 0)
    edges = 0
    for k in ("pre", "suc"):
        for e in g.get(k, ()):
            edges += len(e.get("u", ()))
    for k in ("left", "right"):
        d = g.get(k)
        if isinstance(d, dict):
            edges += len(d.get("u", ()))
    actors = len(scen.get("ctrs", ()))
    rois = scen.get("subgraphs") or ()
    roi_nodes = sum(len(r.get("ctrs", ())) if isinstance(r, dict) else 0 for r in rois)
    return nodes + edges // 4 + 8 * actors + 2 * roi_nodes


def balance_scenarios(scens, g: int, weight_fn=scenario_weight,
                      max_per_group: int | None = None) -> List[List[int]]:
    """Greedy LPT split of scenarios into g groups balanced by weight;
    returns g lists of indices, each in the original order.

    At 1/G sub-capacities a positional split lets a skewed draw (a few
    dense scenarios side by side) overflow one sub-pack and drop edges.
    Sorted by weight, heaviest first, each scenario goes to the lightest
    group that has room (`max_per_group`, the sub-pack's max_scenarios);
    when none has, to the lightest. Ties break on the index, so every rank
    computes the same split."""
    weights = [int(weight_fn(s)) for s in scens]
    order = sorted(range(len(scens)), key=lambda i: (-weights[i], i))
    totals = [0] * g
    groups: List[List[int]] = [[] for _ in range(g)]
    for i in order:
        open_g = [k for k in range(g)
                  if max_per_group is None or len(groups[k]) < max_per_group]
        if not open_g:
            open_g = list(range(g))
        j = min(open_g, key=lambda k: (totals[k], k))
        totals[j] += weights[i]
        groups[j].append(i)
    return [sorted(grp) for grp in groups]


def _divider(g: int, headroom: float):
    """n → (1 + headroom)/G of n, rounded up to a multiple of align; a
    capacity without alignment must divide G ways exactly without
    headroom."""

    def div(n: int, align: int = 1) -> int:
        if n % g and align == 1 and not headroom:
            raise ValueError(f"capacity {n} does not divide {g} ways")
        n = math.ceil(n * (1.0 + headroom))
        return max(-(-n // g // align), 1) * align

    return div


def subdivide_pack_config(cfg: PackConfig, g: int, headroom: float = 0.0) -> PackConfig:
    """The sub-pack config of one graph column: every capacity but
    max_scenarios is (1 + headroom)/G of the whole pack's, its alignment
    kept (node and actor windows whole); the window and actor strides must
    divide the node and actor capacities G ways. The spill plan's capacity
    is kept whole, as the JAX package keeps it. headroom 0 is the JAX
    package's formula."""
    if g == 1:
        return cfg
    div = _divider(g, headroom)
    med = cfg.max_edges_dilated
    med_sub = (tuple(div(m, 128) for m in med) if isinstance(med, (tuple, list))
               else div(med, 128))
    if cfg.max_scenarios % g:
        raise ValueError(f"max_scenarios {cfg.max_scenarios} does not divide {g} ways")
    if cfg.node_stride and cfg.max_nodes % (g * cfg.node_stride):
        raise ValueError("windowed sharding needs max_nodes divisible by G*node_stride")
    if cfg.actor_stride and cfg.max_actors % (g * cfg.actor_stride):
        raise ValueError("windowed sharding needs max_actors divisible by G*actor_stride")
    return dataclasses.replace(
        cfg,
        max_scenarios=cfg.max_scenarios // g,
        max_actors=div(cfg.max_actors, cfg.actor_stride) if headroom and cfg.actor_stride
        else cfg.max_actors // g,
        max_nodes=div(cfg.max_nodes, cfg.node_stride) if headroom and cfg.node_stride
        else cfg.max_nodes // g,
        max_edges_scale0=div(cfg.max_edges_scale0, 128),
        max_edges_dilated=med_sub,
        max_edges_lr=div(cfg.max_edges_lr, 128),
        max_a2m_edges=div(cfg.max_a2m_edges, cfg.pair_chunk),
        max_m2a_edges=div(cfg.max_m2a_edges, cfg.pair_chunk),
        max_a2a_edges=div(cfg.max_a2a_edges, cfg.pair_chunk),
        max_table_edges=div(cfg.max_table_edges) if cfg.max_table_edges else 0,
    )


def subdivide_roi_pack_config(cfg: RoiPackConfig, g: int,
                              headroom: float = 0.0) -> RoiPackConfig:
    """LaneRCNN's sub-pack config of one graph column (as
    subdivide_pack_config: RoI subgraphs and the global graph are both
    per-scenario, so a sub-pack holds whole RoIs and whole scenario
    graphs). The window-chunked pool edges get POOL_SLACK_CHUNKS chunks of
    slack over 1/G: each occupied destination window wastes up to
    WCHUNK - 1 slots to alignment, and G sub-packs touch about as many
    windows as the whole pack. Every capacity but max_scenarios is
    (1 + headroom)/G of the whole pack's, aligned; headroom 0 is the JAX
    package's formula."""
    if g == 1:
        return cfg

    def div(n: int, align: int = 1) -> int:  # the JAX formula takes any n here
        n = math.ceil(n * (1.0 + headroom))
        return max(-(-n // g // align), 1) * align

    if cfg.max_scenarios % g:
        raise ValueError(f"max_scenarios {cfg.max_scenarios} does not divide {g} ways")
    stride = cfg.node_stride or 1
    g_stride = cfg.g_stride or 1
    return dataclasses.replace(
        cfg,
        max_scenarios=cfg.max_scenarios // g,
        max_rois=div(cfg.max_rois, 8),
        max_roi_nodes=div(cfg.max_roi_nodes, stride),
        max_interest_nodes=div(cfg.max_interest_nodes, 128),
        max_global_nodes=div(cfg.max_global_nodes, g_stride) if cfg.max_global_nodes else 0,
        max_edges_scale0=div(cfg.max_edges_scale0, 128),
        max_edges_dilated=div(cfg.max_edges_dilated, 128),
        max_edges_lr=div(cfg.max_edges_lr, 128),
        max_a2m_edges=div(cfg.max_a2m_edges, 128),
        max_pool_edges=div(cfg.max_pool_edges, WCHUNK) + POOL_SLACK_CHUNKS * WCHUNK,
        max_a2r_edges=div(cfg.max_a2r_edges, 128),
        max_table_edges=div(cfg.max_table_edges) if cfg.max_table_edges else 0,
    )


class GraphSplit(NamedTuple):
    """What a loader of graph column `part` of `parts` packs: its share of
    each group of scenarios (balance_scenarios) at `config`'s
    subdivided capacities."""

    part: int
    parts: int
    config: Config


def graph_split(config: Config, mesh: Mesh, family: str) -> GraphSplit:
    """This rank's GraphSplit: the family's pack config subdivided G ways
    with the family's SPLIT_HEADROOM (LaneGCN's `pack` by
    subdivide_pack_config, LaneRCNN's `roi_pack` by
    subdivide_roi_pack_config)."""
    h = SPLIT_HEADROOM[family]
    if family == "lanercnn":
        sub = dataclasses.replace(
            config, roi_pack=subdivide_roi_pack_config(config.roi_pack, mesh.graph, h))
    else:
        sub = dataclasses.replace(config, pack=subdivide_pack_config(config.pack, mesh.graph, h))
    return GraphSplit(mesh.g, mesh.graph, sub)


def split_group(scens, split: GraphSplit) -> list:
    """This column's scenarios of one group, in the group's order."""
    size = -(-len(scens) // split.parts)
    return [scens[i] for i in balance_scenarios(scens, split.parts, max_per_group=size)[split.part]]


def _pack_fields(batch) -> Dict[str, torch.Tensor]:
    """The pack fields the loss and metrics read beside the outputs, with
    LaneGCN's agent_idx still local."""
    if hasattr(batch, "actors"):
        return {"gt_preds": batch.gt_preds, "has_preds": batch.has_preds,
                "mask": batch.actors.mask, "agent_idx": batch.agent_idx,
                "scen_mask": batch.scen_mask}
    return {"gt_preds": batch.gt_preds, "has_preds": batch.has_preds,
            "scen_mask": batch.scen_mask}


class WindowedComm:
    """The collectives of one rank's windowed step (loop.make_train_step's
    `comm`), on `mesh`."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def union(self, out: Dict[str, torch.Tensor], batch):
        """The graph row's outputs (one gather, with a gradient) and loss
        fields (one gather, as fp32: exact for the flags and for row
        indices below 2^24), each in column order; LaneGCN's agent rows
        move by g·A to their union rows."""
        mesh, g = self.mesh, self.mesh.graph
        keys = list(out)
        n = out[keys[0]].shape[0]
        flat = [out[k].reshape(n, -1) for k in keys]
        u = gather_union(torch.cat(flat, 1), mesh)
        out_u, col = {}, 0
        for k, f in zip(keys, flat):
            out_u[k] = u[:, col:col + f.shape[1]].reshape((g * n,) + out[k].shape[1:]).contiguous()
            col += f.shape[1]

        fields = _pack_fields(batch)
        if "agent_idx" in fields:
            fields["agent_idx"] = fields["agent_idx"] + mesh.g * batch.actors.mask.shape[0]
        buf = torch.cat([v.reshape(-1).float() for v in fields.values()])
        rows = all_gather_rows(buf, mesh).view(g, -1)
        fu, off = {}, 0
        for k, v in fields.items():
            part = rows[:, off:off + v.numel()].reshape((g * v.shape[0],) + v.shape[1:])
            off += v.numel()
            fu[k] = (part > 0.5 if v.dtype == torch.bool else part.to(v.dtype)).contiguous()
        if "mask" in fu:
            fu["actors"] = dataclasses.replace(batch.actors, mask=fu.pop("mask"))
        return out_u, dataclasses.replace(batch, **fu)

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One all_reduce over the data column: the loss averaged, every
        other metric summed."""
        keys = list(metrics)
        vals = torch.stack([metrics[k].float() for k in keys])
        dist.all_reduce(vals, group=self.mesh.data_group)
        self.mesh.count("all_reduce", vals.numel() * vals.element_size())
        out = dict(zip(keys, vals.unbind()))
        out["loss"] = out["loss"] / self.mesh.data
        return out

    def reduce_grad(self, flat: torch.Tensor) -> torch.Tensor:
        """The flat gradient averaged over every rank (in place: it is the
        optimizer's fresh concatenation)."""
        dist.all_reduce(flat)
        self.mesh.count("all_reduce", flat.numel() * flat.element_size())
        return flat.div_(self.mesh.world)


def make_windowed_parallel_train_step(config: Config, net, state, mesh: Mesh, device=None,
                                      loss_fn=None, metrics_fn=None):
    """One rank's step of a D×G mesh: fn(sub_pack, epoch) → metrics.

    make_train_step's arguments plus the mesh. sub_pack is this rank's
    share of its data row's group (subdivide_pack_config capacities). The
    loss and metrics equal the single-device step's on the union of the
    row's G sub-packs (the loss averaged over the D rows, the other metrics
    summed), and the update is the single-device update on the mean of the
    D rows' gradients; net and state must start equal on every rank (the
    CLI broadcasts rank 0's)."""
    return make_train_step(config, net, state, device=device or mesh.device, loss_fn=loss_fn,
                           metrics_fn=metrics_fn, comm=WindowedComm(mesh))


def make_windowed_parallel_roi_train_step(config: Config, net, state, mesh: Mesh,
                                          device=None, loss_fn=None, metrics_fn=None):
    """LaneRCNN's windowed step: its loss and metrics are per scenario, so
    the union is the three outputs and gt_preds, has_preds, scen_mask.
    loss_fn and metrics_fn default to roi_loss and roi_metrics."""
    from lanegcn_tpu_torch.models.lanercnn import roi_loss, roi_metrics

    return make_windowed_parallel_train_step(config, net, state, mesh, device,
                                             loss_fn or roi_loss, metrics_fn or roi_metrics)


def make_parallel_train_step(config: Config, net, state, mesh: Mesh, device=None,
                             loss_fn=None, metrics_fn=None):
    """Data parallel: each rank trains its own whole pack, the loss is the
    mean of the D packs' losses and the gradient their mean (the
    reference's Horovod semantics, train.py:66-69): the windowed step with
    G = 1."""
    if mesh.graph != 1:
        raise ValueError(f"data parallel takes a Dx1 mesh, not {mesh.data}x{mesh.graph}")
    return make_windowed_parallel_train_step(config, net, state, mesh, device, loss_fn,
                                             metrics_fn)


def broadcast_train_state(net, state, mesh: Mesh) -> None:
    """Rank 0's parameters and optimizer state on every rank (the
    reference's hvd.broadcast_parameters and broadcast_optimizer_state,
    train.py:145-146), once at the start: the flat buffer in place (the
    parameters are its views), every buffer of the net and the optimizer's
    state tensors."""
    opt = state.opt
    tensors = [opt.flat] + [getattr(opt, k) for k in opt.STATE] + list(net.buffers())
    for t in tensors:
        dist.broadcast(t, src=0)
        mesh.count("broadcast", t.numel() * t.element_size())
