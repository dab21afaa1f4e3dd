"""The actor-map fusion cycle: Att, A2M, M2M, M2A, A2A
(reference lanegcn.py:366-545, 634-710).

`Att` is the distance-gated sparse attention: for every fusion edge (u ← v)
within a distance threshold, an edge MLP consumes the relative offset, a
query projection of the destination and the source feature; edge outputs
sum into the destination, followed by GN → ReLU → Linear → residual → ReLU.

The port runs the JAX package's two branches for n_agt == n_ctx, whichever
the pack carries:
- the window-pair branch: the distance embedding is affine in the endpoint
  centers (d@Wd = ctr_u@Wd − ctr_v@Wd), so every per-edge input folds into
  dense per-row projections and the gathers, the edge MLP and the
  destination scatter run in the `win_edge` kernel over the pack's
  window-pair plan; when training, each fusion stage prepares the plan for
  the backward once (`prepare_pair`) and its Att layers share it;
- the edge-list branch (flat fusion lists): the query and context
  projections run densely per row and are gathered per edge
  (`masked_gather`, which computes what the JAX package's
  `sorted_transpose_gather` does), the per-edge chain runs in the
  `edge_mlp` kernel, and its rows are added into their destinations by
  `scatter_add`.
Both end in the `row_tail` kernel. Att with n_agt != n_ctx is not ported
yet and raises NotImplementedError.
"""

from __future__ import annotations

import torch
from torch import nn

from lanegcn_tpu_torch.config import ModelConfig
from lanegcn_tpu_torch.graph import EdgeSet, LaneGraphBatch, PairPlan
from lanegcn_tpu_torch.models.layers import Dense, GroupNorm, Linear
from lanegcn_tpu_torch.models.map_net import LaneConvStack, graph_inputs
from lanegcn_tpu_torch.ops.scatter import dst_order, masked_gather, scatter_add, src_order
from lanegcn_tpu_torch.ops.edge_mlp import fused_edge_mlp
from lanegcn_tpu_torch.ops.row_tail import fused_row_tail
from lanegcn_tpu_torch.ops.win_edge import prepare_pair, win_edge_mlp


class Att(nn.Module):
    """Distance-gated sparse attention (reference lanegcn.py:634-710), with
    the reference's module names (dist, query, ctx, agt, norm, linear)."""

    def __init__(self, n_agt: int, n_ctx: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_agt, self.n_ctx, self.dtype = n_agt, n_ctx, dtype
        self.dist = nn.Sequential(
            Dense(2, n_ctx, dtype=dtype), nn.ReLU(), Linear(n_ctx, n_ctx, dtype=dtype)
        )
        self.query = Linear(n_agt, n_ctx, dtype=dtype)
        self.ctx = nn.Sequential(
            Linear(3 * n_ctx, n_agt, dtype=dtype), Dense(n_agt, n_agt, bias=False, dtype=dtype)
        )
        self.agt = Dense(n_agt, n_agt, bias=False, dtype=dtype)
        self.norm = GroupNorm(n_agt)
        self.linear = Linear(n_agt, n_agt, act=False, dtype=dtype)

    def forward(self, agts, agt_ctrs, ctx, ctx_ctrs, pair: PairPlan | None,
                edges: EdgeSet | None = None, prep=None):
        """agts [A, n_agt] (destinations), ctx [S, n_ctx] (sources), their
        centers; `pair`, the window-pair plan of the fusion edges (with
        `prep`, its `prepare_pair` for the backward, or None), or None and
        `edges`, the same edges as a list (u → agts rows, v → ctx rows)."""
        if self.n_agt != self.n_ctx:
            raise NotImplementedError("Att with n_agt != n_ctx is not ported yet")
        res = agts
        c = self.n_ctx
        dt = self.dtype
        dist_dense = self.dist[0]
        kd, bd = dist_dense.kernel, dist_dense.bias
        k_ch = self.ctx[0].linear.kernel  # [3C, C]: dist | query | ctx segments
        query_all = self.query(agts)
        qd = query_all.to(dt) @ k_ch[c : 2 * c].to(dt)
        cs = ctx.to(dt) @ k_ch[2 * c :].to(dt)
        temp = self.agt(agts)
        chain = self.chain()
        if pair is not None:
            # Sign folding: Pd = ctr_u@Wd, Ps = −ctr_v@Wd; bd is added once per edge.
            pd = agt_ctrs.to(dt) @ kd.to(dt)
            ps = -(ctx_ctrs.to(dt) @ kd.to(dt))
            agts = win_edge_mlp(pd.contiguous(), qd.contiguous(), ps.contiguous(),
                                cs.contiguous(), temp.to(dt).contiguous(), bd, *chain, pair,
                                prep=prep)
        else:
            u, v, mask = edges.u, edges.v, edges.mask
            # The centre offset per edge (centers are data: no gradient).
            d = masked_gather(agt_ctrs, u, mask) - masked_gather(ctx_ctrs, v, mask)
            # The lists' own orders (destination-sorted, with the source
            # inverse) for the scatter and the gathers' backward.
            by_dst = dst_order(edges, agts.shape[0])
            qg = masked_gather(qd, u, mask, by_dst)
            cg = masked_gather(cs, v, mask, src_order(edges, ctx.shape[0]))
            edge_out = fused_edge_mlp(d.float(), qg.to(dt), cg.to(dt), kd, bd, *chain)
            agts = scatter_add(edge_out, u, agts.shape[0], mask=mask, out=temp, order=by_dst)
        return self.tail(agts, res)

    def chain(self) -> tuple:
        """The per-edge chain's weights after the distance embedding, as
        fused_edge_mlp and win_edge_mlp take them."""
        dist_out, (ctx_hidden, ctx_out) = self.dist[2], self.ctx
        return (dist_out.linear.kernel, dist_out.norm.weight, dist_out.norm.bias,
                ctx_hidden.linear.kernel[:self.n_ctx], ctx_hidden.norm.weight,
                ctx_hidden.norm.bias, ctx_out.kernel)

    def tail(self, temp: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
        """relu(GN(temp)) → Linear → GN → + res → relu, in the `row_tail`
        kernel."""
        dt = self.dtype
        return fused_row_tail(
            temp.to(dt).contiguous(), res.to(dt).contiguous(), self.linear.linear.kernel,
            self.norm.weight, self.norm.bias, self.linear.norm.weight, self.linear.norm.bias,
        )


def pair_prep(pair: PairPlan | None, nd: int, ns: int):
    """The stage's pair plan prepared for win_edge's backward, once for its
    Att layers; None without a plan or a gradient (serving)."""
    if pair is None or not torch.is_grad_enabled():
        return None
    return prepare_pair(pair, nd, ns)


class A2M(nn.Module):
    """Actor → lane-node fusion (reference lanegcn.py:366-407)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.meta = Linear(cfg.n_map + 4, cfg.n_map, dtype=dtype)
        self.att = nn.ModuleList(
            [Att(cfg.n_map, cfg.n_actor, dtype=dtype) for _ in range(cfg.num_att_layers)])

    def forward(self, nodes, graph: LaneGraphBatch, actors, actor_ctrs, edges: EdgeSet, pair):
        meta = torch.cat(
            [graph.turn, graph.control[:, None], graph.intersect[:, None]], dim=-1)
        nodes = self.meta(torch.cat([nodes, meta.to(nodes.dtype)], dim=-1))
        prep = pair_prep(pair, nodes.shape[0], actors.shape[0])
        for att in self.att:
            nodes = att(nodes, graph.ctrs, actors, actor_ctrs, pair, edges, prep)
        return nodes


class M2M(nn.Module):
    """Lane → lane propagation: a LaneConv stack without input embedding
    (reference lanegcn.py:410-480)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fuse = LaneConvStack(cfg, cfg.num_fuse_layers, dtype=dtype)

    def forward(self, nodes, graph: LaneGraphBatch, spill_prep=None):
        """spill_prep: the graph's spill plan prepared once for MapNet's and
        this stack (`map_net.graph_spill`), or None to prepare it here."""
        return self.fuse(nodes, **graph_inputs(graph), spill_prep=spill_prep)


class M2A(nn.Module):
    """Lane-node → actor fusion (reference lanegcn.py:483-513)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att = nn.ModuleList(
            [Att(cfg.n_actor, cfg.n_map, dtype=dtype) for _ in range(cfg.num_att_layers)])

    def forward(self, actors, actor_ctrs, nodes, node_ctrs, edges: EdgeSet, pair):
        prep = pair_prep(pair, actors.shape[0], nodes.shape[0])
        for att in self.att:
            actors = att(actors, actor_ctrs, nodes, node_ctrs, pair, edges, prep)
        return actors


class A2A(nn.Module):
    """Actor ↔ actor interaction (reference lanegcn.py:516-545)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att = nn.ModuleList(
            [Att(cfg.n_actor, cfg.n_actor, dtype=dtype) for _ in range(cfg.num_att_layers)])

    def forward(self, actors, actor_ctrs, edges: EdgeSet, pair):
        prep = pair_prep(pair, actors.shape[0], actors.shape[0])
        for att in self.att:
            actors = att(actors, actor_ctrs, actors, actor_ctrs, pair, edges, prep)
        return actors
