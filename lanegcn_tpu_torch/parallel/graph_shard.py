"""Source-partitioned LaneConv and Att on torch.distributed: the port's
counterpart of lanegcn_tpu/parallel/graph_shard.py.

A node space of N rows is split into G contiguous row blocks, one per rank
of the graph row: rank g owns rows [g·n, (g+1)·n), n = N/G. Each edge list
is split on the host by the owner of its source row v (v becomes
shard-local, u stays pack-global), so a rank gathers from its own rows only,
and one reduce-scatter a layer brings every destination row its messages:

  LaneConv layer, on rank g:
    M_r      = X_local[v] @ W_r                     the rank's edges of relation r
    partial  = own(W_ctr X_local) + scatter_add(M → u)       [N, C]
    X'_local = row_tail(reduce_scatter_rows(partial), X_local)
               (relu(GN(temp)) → Linear → GN → + X_local → relu)

  Att layer (destination rows A and source rows split alike):
    qd       = gather_union(query(agts_local) @ K_q)            [A, C]
    e        = edge_mlp(d, qd[u], (ctx_local @ K_c)[v])         the rank's edges
               (at n_agt != n_ctx: gather_union(query(agts_local)), then
               Att.unequal's distance MLP, SplitLinear and ctx_out per edge)
    partial  = own(W_agt agts_local) + scatter_add(e → u)       [A, C]
    agts'    = row_tail(reduce_scatter_rows(partial), agts_local)

own(·) puts a rank's residual term at its own rows of the partial, zero
elsewhere, so each row's sum starts where the one-card layer's does
(LaneConvStack's unfused branch, Att's edge-list branch, which also take
the products on the gathered rows): at G = 1 the arithmetic is the
one-card layer's, and at G > 1 the reduce-scatter's sum of the ranks'
partials is the only reordering. The JAX layer takes every row's products
before the gather and adds the residual term after its psum_scatter: the
same function, other roundings. They run the one-card path's kernels: the
row gathers' backward and the scatters on `segment_sum`, the edge chain on
`edge_mlp` (Att's flags), the tails on `row_tail`; the two collectives are
each other's gradient (mesh.py). The partial sums are in the activation
dtype, as the JAX package reduces them. The modules are the one-card
model's (`LaneConvStack`, `Att`): the same parameters, state dicts and
checkpoints.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lanegcn_tpu_torch.graph import EdgeSet
from lanegcn_tpu_torch.ops.edge_mlp import fused_edge_mlp
from lanegcn_tpu_torch.ops.scatter import EdgeOrder, masked_gather, order_by, scatter_add
from lanegcn_tpu_torch.parallel.mesh import Mesh, gather_union, reduce_scatter_rows


def partition_one(u, v, mask, n_src: int, num_shards: int,
                  cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host side: one edge list split by the owner of its v among n_src rows
    into [G, cap] arrays (v local, u kept, each shard's edges in list
    order); a shard past cap drops its tail edges, counted in the returned
    total."""
    rows = n_src // num_shards
    u, v, m = np.asarray(u), np.asarray(v), np.asarray(mask)
    owner = np.where(m, v // rows, 0)
    su = np.zeros((num_shards, cap), np.int32)
    sv = np.zeros((num_shards, cap), np.int32)
    sm = np.zeros((num_shards, cap), bool)
    dropped = 0
    for s in range(num_shards):
        sel = m & (owner == s)
        k = int(sel.sum())
        if k > cap:
            dropped += k - cap
            k = cap
        su[s, :k] = u[sel][:k]
        sv[s, :k] = v[sel][:k] - s * rows
        sm[s, :k] = True
    return su, sv, sm, dropped


def partition_edges_by_source(edges: Dict[str, EdgeSet], num_nodes: int,
                              num_shards: int) -> Dict[str, EdgeSet]:
    """Host side: split every relation's edges by the owner shard of the
    source row v; v becomes shard-local, u stays pack-global. Returns numpy
    EdgeSets with a leading shard axis [G, E_shard] (E_shard: the largest
    shard's count, at least 1)."""
    if num_nodes % num_shards:
        raise ValueError(f"{num_nodes} rows do not split {num_shards} ways")
    rows = num_nodes // num_shards
    out = {}
    for name, e in edges.items():
        v, m = np.asarray(e.v), np.asarray(e.mask)
        cap = max(int(np.bincount(v[m] // rows, minlength=1).max(initial=0)), 1)
        su, sv, sm, _ = partition_one(e.u, e.v, e.mask, num_nodes, num_shards, cap)
        out[name] = EdgeSet(u=su, v=sv, mask=sm)
    return out


def partition_edge_set_by_source(edges: EdgeSet, num_src: int, num_shards: int) -> EdgeSet:
    """partition_edges_by_source of one EdgeSet."""
    return partition_edges_by_source({"e": edges}, num_src, num_shards)["e"]


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of x's rows."""
    n = x.shape[0] // mesh.graph
    return x[mesh.g * n:(mesh.g + 1) * n]


def own_rows(x_local: torch.Tensor, num_rows: int, mesh: Mesh) -> torch.Tensor:
    """[num_rows, ...]: x_local at this rank's rows, zero elsewhere: the base
    a partial sum starts from, so that the residual term of a rank's rows is
    added where the one-card layer adds it."""
    start = mesh.g * x_local.shape[0]
    pad = (0, 0) * (x_local.dim() - 1) + (start, num_rows - start - x_local.shape[0])
    return torch.nn.functional.pad(x_local, pad)


class RelationLists(NamedTuple):
    """One node space's relations on this rank as one list, relation after
    relation (`caps` slots each): sources `src` among its rows, destinations
    `dst` among the pack's; the orders are made once and shared by every
    layer on the space."""

    src: torch.Tensor
    dst: torch.Tensor
    mask: torch.Tensor
    caps: List[int]
    by_src: Optional[EdgeOrder]
    by_dst: EdgeOrder


def relation_lists(edges: Dict[str, EdgeSet], names, rows: int,
                   num_nodes: int) -> RelationLists:
    """This rank's edges of the relations `names` (v local to its `rows`
    rows, u among num_nodes), in one list with its destination order and,
    when a gradient is wanted, its source order: one sort each."""
    src = torch.cat([edges[nm].v for nm in names])
    dst = torch.cat([edges[nm].u for nm in names])
    mask = torch.cat([edges[nm].mask for nm in names])
    by_src = order_by(src, mask, rows) if torch.is_grad_enabled() else None
    return RelationLists(src, dst, mask, [edges[nm].u.shape[0] for nm in names], by_src,
                         order_by(dst, mask, num_nodes))


def lane_conv_layer_sharded(stack, i: int, x_local: torch.Tensor, lists: RelationLists,
                            num_nodes: int, mesh: Mesh) -> torch.Tensor:
    """Layer i of `stack` (a LaneConvStack) on this rank's rows x_local."""
    # The one-card branch's operations in its order: autograd then sums
    # each tensor's cotangents in the same order too.
    dt = stack.dtype
    temp = own_rows(stack["ctr"][i](x_local), num_nodes, mesh)
    w_rel = torch.stack([stack[nm][i].kernel for nm in stack.names], 0)
    rows = masked_gather(x_local, lists.src, lists.mask, lists.by_src).to(dt).split(lists.caps)
    msgs = torch.cat([x @ w_rel[r].to(dt) for r, x in enumerate(rows)])
    partial = scatter_add(msgs, lists.dst, num_nodes, mask=lists.mask, out=temp,
                          order=lists.by_dst)
    return stack.row_tail(i, reduce_scatter_rows(partial, mesh), x_local)


def lane_conv_stack_sharded(stack, x_local: torch.Tensor, lists: RelationLists,
                            num_nodes: int, mesh: Mesh) -> torch.Tensor:
    """Every layer of `stack` on this rank's rows (one reduce-scatter each)."""
    for i in range(stack.num_layers):
        x_local = lane_conv_layer_sharded(stack, i, x_local, lists, num_nodes, mesh)
    return x_local


class FusionLists(NamedTuple):
    """A fusion stage's edges on this rank (u among the destinations' rows,
    v local to the sources'), with their orders, shared by the stage's Att
    layers."""

    edges: EdgeSet
    by_src: Optional[EdgeOrder]
    by_dst: EdgeOrder


def fusion_lists(edges: EdgeSet, num_dst: int, num_src_local: int) -> FusionLists:
    """One stable sort by destination and, when a gradient is wanted, one
    by source."""
    by_src = order_by(edges.v, edges.mask, num_src_local) if torch.is_grad_enabled() else None
    return FusionLists(edges, by_src, order_by(edges.u, edges.mask, num_dst))


def att_sharded(att, agts_local: torch.Tensor, agt_ctrs: torch.Tensor, ctx_local: torch.Tensor,
                ctx_ctrs_local: torch.Tensor, lists: FusionLists, mesh: Mesh) -> torch.Tensor:
    """One Att layer (a models.fusion.Att) with its destinations (the rows of
    agt_ctrs, whole) and sources split over the graph row: the edge-list
    branch of Att.forward on this rank's edges, then one reduce-scatter."""
    e = lists.edges
    if att.n_agt != att.n_ctx:  # Att.unequal's operations, the query rows gathered first
        query_all = gather_union(att.query(agts_local), mesh)
        temp = own_rows(att.agt(agts_local), agt_ctrs.shape[0], mesh)
        partial = att.unequal_partial(query_all, temp, agt_ctrs, ctx_local, ctx_ctrs_local, e,
                                      lists.by_dst, lists.by_src)
        return att.tail(reduce_scatter_rows(partial, mesh), agts_local)
    # Att.forward's operations in its order (as lane_conv_layer_sharded).
    c, dt = att.n_ctx, att.dtype
    dist_dense = att.dist[0]
    k_ch = att.ctx[0].linear.kernel  # [3C, C]: dist | query | ctx segments
    qd = gather_union(att.query(agts_local).to(dt) @ k_ch[c:2 * c].to(dt), mesh)
    cs = ctx_local.to(dt) @ k_ch[2 * c:].to(dt)
    temp = own_rows(att.agt(agts_local), agt_ctrs.shape[0], mesh)
    chain = att.chain()
    d = masked_gather(agt_ctrs, e.u, e.mask) - masked_gather(ctx_ctrs_local, e.v, e.mask)
    qg = masked_gather(qd, e.u, e.mask, lists.by_dst)
    cg = masked_gather(cs, e.v, e.mask, lists.by_src)
    out = fused_edge_mlp(d.float(), qg.to(dt), cg.to(dt), dist_dense.kernel, dist_dense.bias,
                         *chain)
    partial = scatter_add(out, e.u, agt_ctrs.shape[0], mask=e.mask, out=temp,
                          order=lists.by_dst)
    return att.tail(reduce_scatter_rows(partial, mesh), agts_local)


def make_sharded_lane_conv(mesh: Mesh, num_nodes: int):
    """fn(stack, feat_local [n, C], edges) → [n, C]: a LaneConvStack's
    layers on this rank's rows of a num_nodes-row space, `edges` this
    rank's source-partitioned relations (partition_edges_by_source's row
    mesh.g, as tensors)."""

    def fn(stack, feat_local, edges):
        lists = relation_lists(edges, stack.names, feat_local.shape[0], num_nodes)
        return lane_conv_stack_sharded(stack, feat_local, lists, num_nodes, mesh)

    return fn


def make_sharded_att(mesh: Mesh):
    """fn(att, agts_local, agt_ctrs [A, 2], ctx_local, ctx_ctrs_local,
    edges) → this rank's rows of one Att layer, `edges` this rank's fusion
    edges partitioned by source (u among the A destination rows)."""

    def fn(att, agts_local, agt_ctrs, ctx_local, ctx_ctrs_local, edges):
        lists = fusion_lists(edges, agt_ctrs.shape[0], ctx_local.shape[0])
        return att_sharded(att, agts_local, agt_ctrs, ctx_local, ctx_ctrs_local, lists, mesh)

    return fn
