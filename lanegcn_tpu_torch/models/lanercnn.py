"""LaneRCNN: per-agent LaneRoI encoding + anchor-based decoding, on RoI packs.

Pipeline (reference lanercnn.py:85-119; the JAX package's
models/lanercnn.py):
    LaneInput → LaneRoI₁ → Interactor(roi2graph → global LaneConv stack →
    graph2roi) → LaneRoI₂ → Decode(goal head → segmented NMS → quadratic
    trajectory fit → agent-motion LanePooling refinement)

The RoI subgraphs of a pack are flattened RoI-major into one node space
(data/packing_roi.py); the global lane graph is LaneGCN's. Both LaneConv
stacks are `LaneConvStack` on their own node space. LanePooling runs its
per-edge chain in the `edge_mlp` kernel (LanePooling's configuration), the
scatter into its target rows in the `window_scatter` kernel where the pool
edges are window-chunked (r2g, g2r) and `scatter_add` where they are flat
(a2r), and its two-Linear tail in the K = 2 `row_tail` kernel; each of the
three runs through an autograd Function with a backward kernel, so the
model trains. With remat=True the three LanePoolings run under activation
checkpointing (their per-edge [E, 128] tensors are recomputed in the
backward instead of kept). Module names follow the reference LaneRCNN, so
a state_dict keyed by them loads with strict=True (utils/weights.py
`lanercnn_table`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lanegcn_tpu_torch.config import LossConfig, ModelConfig
from lanegcn_tpu_torch.device import resolve_device
from lanegcn_tpu_torch.graph import EdgeSet, RoiPackedBatch
from lanegcn_tpu_torch.models.layers import Dense, GroupNorm, Linear, init_parameters
from lanegcn_tpu_torch.models.lanegcn import smooth_l1
from lanegcn_tpu_torch.models.map_net import LaneConvStack, graph_inputs
from lanegcn_tpu_torch.ops.scatter import dst_order, masked_gather, scatter_add, src_order
from lanegcn_tpu_torch.ops.edge_mlp import fused_edge_mlp
from lanegcn_tpu_torch.ops.row_tail import fused_row_tail2
from lanegcn_tpu_torch.ops.window_scatter import window_scatter_add


def _embed(n: int, dtype) -> nn.Sequential:
    """Dense(2, n) → ReLU → Linear(act=False): the reference's 2-d embeds."""
    return nn.Sequential(Dense(2, n, dtype=dtype), nn.ReLU(), Linear(n, n, act=False, dtype=dtype))


class LaneInput(nn.Module):
    """RoI-node embedding + agent-feature scatter (reference lanercnn.py:280-351)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.map_fc = Dense(8, cfg.n_map, bias=False, dtype=dtype)
        self.agt_fc = Dense(4 * cfg.num_hist, cfg.n_map, bias=False, dtype=dtype)
        self.bn = GroupNorm(cfg.n_map)

    def forward(self, batch: RoiPackedBatch) -> torch.Tensor:
        map_feats = self.map_fc(batch.node_feats)
        agt = self.agt_fc(batch.agent_feat)
        a2m = batch.a2m
        msg = masked_gather(agt, a2m.u, a2m.mask, dst_order(a2m, agt.shape[0]))
        m = map_feats.shape[0]  # a scatter by source: the pack's inverse where it has one
        map_feats = scatter_add(msg, a2m.v, m, mask=a2m.mask, out=map_feats,
                                order=src_order(a2m, m))
        return torch.relu(self.bn(map_feats))


class LaneRoI(nn.Module):
    """Input Linear + LaneConv stack over the RoI subgraphs (reference
    lanercnn.py:354-430)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input = Linear(cfg.n_map, cfg.n_map, dtype=dtype)
        self.fuse = LaneConvStack(cfg, cfg.num_fuse_layers, dtype=dtype)

    def forward(self, feat, edges, bands, tables=None, plan=None) -> torch.Tensor:
        return self.fuse(self.input(feat), edges, bands, tables, plan)


class LanePooling(nn.Module):
    """Graph → graph fusion through a relative-pose edge MLP (reference
    lanercnn.py:433-514). Edges: u → target rows, v → context rows."""

    def __init__(self, n: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n, self.dtype = n, dtype
        self.input = Dense(n, n, bias=False, dtype=dtype)
        self.relpose = nn.Sequential(Dense(4, n, dtype=dtype), nn.ReLU())
        self.ctx = nn.Sequential(Linear(2 * n, n, dtype=dtype),
                                 Dense(n, n, bias=False, dtype=dtype))
        self.mlp = nn.Sequential(Linear(n, n, dtype=dtype), Linear(n, n, act=False, dtype=dtype))
        self.norm = GroupNorm(n)

    def forward(self, context_feat, context_pose, target_feat, target_pose,
                edges: EdgeSet) -> torch.Tensor:
        n, dt = self.n, self.dtype
        # Per-edge relative pose: context − target (reference lanercnn.py:494).
        d = masked_gather(context_pose, edges.v, edges.mask) - masked_gather(
            target_pose, edges.u, edges.mask)
        relpose = self.relpose[0]
        ctx_hidden, ctx_out = self.ctx
        k_ch = ctx_hidden.linear.kernel  # [2n, n]: context | relative-pose segments
        # The context segment applies per context row, densely, before the
        # edge gather (reference lanercnn.py:497-505).
        cg = masked_gather(context_feat.to(dt) @ k_ch[:n].to(dt), edges.v, edges.mask,
                           src_order(edges, context_feat.shape[0]))
        ctx = fused_edge_mlp(d.float(), None, cg.to(dt), relpose.kernel, relpose.bias, None, None,
                             None, k_ch[n:], ctx_hidden.norm.weight, ctx_hidden.norm.bias,
                             ctx_out.kernel, False, False)
        tgt = self.input(target_feat)
        if edges.win_lu is not None:
            tgt = window_scatter_add(ctx.to(tgt.dtype), tgt, edges.win_lu, edges.win_chunk,
                                     edges.win_stride)
        else:
            tgt = scatter_add(ctx, edges.u, tgt.shape[0], mask=edges.mask, out=tgt,
                              order=dst_order(edges, tgt.shape[0]))
        # GN → ReLU → mlp.0 → mlp.1 → +res → ReLU (reference lanercnn.py:497-505).
        mlp1, mlp2 = self.mlp
        return fused_row_tail2(
            tgt.to(dt), target_feat.to(dt), mlp1.linear.kernel, mlp2.linear.kernel,
            self.norm.weight, self.norm.bias, mlp1.norm.weight, mlp1.norm.bias,
            mlp2.norm.weight, mlp2.norm.bias,
        )


def _pool(stage: LanePooling, remat: bool, *args) -> torch.Tensor:
    """One LanePooling, rematerialized in the backward when remat is set
    (the JAX package's nn.remat, lanercnn.py:203, :377)."""
    if remat:
        return checkpoint(stage, *args, use_reentrant=False)
    return stage(*args)


class Interactor(nn.Module):
    """RoI → global graph → RoI interaction (reference lanercnn.py:603-642)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        n = cfg.n_map
        self.remat = remat
        self.input = _embed(n, dtype)
        self.seg = _embed(n, dtype)
        self.roi2graph = LanePooling(n, dtype)
        self.global_graph_net = nn.ModuleDict(
            {"fuse": LaneConvStack(cfg, cfg.num_fuse_layers, dtype=dtype)})
        self.graph2roi = LanePooling(n, dtype)

    def forward(self, batch: RoiPackedBatch, roi_feat: torch.Tensor) -> torch.Tensor:
        g = batch.graph
        graph_input = torch.relu(self.input(g.ctrs) + self.seg(g.feats))
        roi_pose = batch.node_feats[:, :4]
        graph_pose = torch.cat([g.ctrs, g.feats], dim=-1)
        graph_feat = _pool(self.roi2graph, self.remat, roi_feat, roi_pose, graph_input,
                           graph_pose, batch.r2g)
        graph_feat = self.global_graph_net["fuse"](graph_feat, **graph_inputs(g))
        return _pool(self.graph2roi, self.remat, graph_feat, graph_pose, roi_feat, roi_pose,
                     batch.g2r)


def segmented_nms(xy, logits, seg, mask, num_seg: int, k: int = 6,
                  threshold: float = 2.0) -> torch.Tensor:
    """Fixed-K greedy NMS per segment (reference nms_select
    lanercnn.py:687-708 as the JAX package's masked argmax loop). Returns
    [num_seg, k] indices into the MI axis: each round picks the
    highest-logit unsuppressed node of each segment, or, when all are
    suppressed, the highest-logit unchosen one; ties go to the first
    index. Empty segments pick index 0 and mark nothing."""
    neg = -1e9
    mi = xy.shape[0]
    dev = xy.device
    logits = logits.float()
    seg_onehot = (seg[None, :] == torch.arange(num_seg, device=dev)[:, None]) & mask[None, :]
    seg_valid = seg_onehot.any(1)  # [B]
    seg_c = seg.clamp(0, num_seg - 1)
    suppressed = torch.zeros(mi, dtype=torch.bool, device=dev)
    chosen = torch.zeros(mi + 1, dtype=torch.bool, device=dev)  # row mi: empty segments
    picks = []
    for _ in range(k):
        s1 = torch.where(mask & ~suppressed & ~chosen[:mi], logits, neg)
        s2 = torch.where(mask & ~chosen[:mi], logits, neg)
        m1 = torch.where(seg_onehot, s1[None, :], neg)  # [B, MI]
        m2 = torch.where(seg_onehot, s2[None, :], neg)
        has1 = m1.amax(1) > neg / 2
        pick = torch.where(has1, m1.argmax(1), m2.argmax(1))  # [B]
        chosen[torch.where(seg_valid, pick, mi)] = True
        # Suppress nodes within threshold of their segment's new pick.
        my_pick_xy = xy[pick][seg_c]
        d = (xy - my_pick_xy).square().sum(1).sqrt()
        suppressed = suppressed | ((d < threshold) & seg_valid[seg_c])
        picks.append(pick)
    return torch.stack(picks, 1)


def _quad_coefficients(agt_ctrs, agt_dirs, pred_ctrs, pred_dirs, k: int):
    """Quadratic curve x(s), y(s) through agent pose → goal pose
    (reference compute_coefficent lanercnn.py:710-723)."""
    ax, ay = agt_ctrs[:, None, 0], agt_ctrs[:, None, 1]
    adx, ady = agt_dirs[:, None, 0], agt_dirs[:, None, 1]
    a1 = (2 * pred_ctrs[:, :, 0] * adx + 2 * ax * adx) / (2 + adx - pred_dirs[:, :, 0])
    a0 = pred_ctrs[:, :, 0] - ax - a1
    a2 = ax.repeat(1, k)
    b1 = (2 * pred_ctrs[:, :, 1] * ady + 2 * ay * ady) / (2 + ady - pred_dirs[:, :, 1])
    b0 = pred_ctrs[:, :, 1] - ay - b1
    b2 = ay.repeat(1, k)
    return tuple(x[:, :, None] for x in (a0, a1, a2, b0, b1, b2))


def _sample_traj(s, a0, a1, a2, b0, b1, b2):
    return torch.stack([a0 * s ** 2 + a1 * s + a2, b0 * s ** 2 + b1 * s + b2], dim=-1)


def _sample_d1_traj(s, a0, a1, a2, b0, b1, b2):
    return torch.stack([2 * a0 * s + a1, 2 * b0 * s + b1], dim=-1)


class Decode(nn.Module):
    """Anchor-based decoding (reference lanercnn.py:740-924)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        n = cfg.n_actor
        self.pred = nn.Sequential(Linear(cfg.n_map, n, dtype=dtype), Dense(n, 5, dtype=dtype))
        self.agt_layer1 = _embed(n, dtype)
        self.agt_layer2 = _embed(n, dtype)
        self.lane_pool = LanePooling(n, dtype)
        self.refinement = nn.Sequential(Linear(n, n, dtype=dtype),
                                        Dense(n, 2 * cfg.num_preds, dtype=dtype))

    def forward(self, roi_feat, batch: RoiPackedBatch
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        k, t_pred = self.cfg.num_mods, self.cfg.num_preds
        b, t_hist = batch.agt_trajs.shape[0], batch.agt_trajs.shape[1]
        dev = roi_feat.device

        int_feats = roi_feat[batch.int_node_idx]  # [MI, C]
        pred = self.pred(int_feats)  # [MI, 5]
        anchors = batch.node_feats[batch.int_node_idx]
        anc_ctrs, anc_dirs = anchors[:, :2], anchors[:, 2:4]
        anc_theta = torch.atan2(anc_dirs[:, 1], anc_dirs[:, 0])

        logits = pred[:, 0]
        pred_xy = anc_ctrs + pred[:, 1:3]
        # The reference takes arctan(p3/p4) of raw outputs (lanercnn.py:785-826);
        # a sign-preserving epsilon on the denominator gives the same value
        # wherever |p4| > eps and a finite angle at p4 == 0.
        denom = pred[:, 4]
        safe_denom = torch.where(denom.abs() < 1e-6, torch.where(denom < 0, -1e-6, 1e-6), denom)
        pred_theta = anc_theta + torch.atan(pred[:, 3] / safe_denom)

        sel = segmented_nms(pred_xy, logits, batch.int_node_scen, batch.int_node_mask, b, k)
        pred_ctrs = pred_xy[sel]  # [B, k, 2]
        pred_thetas = pred_theta[sel]
        pred_logits = logits[sel]
        pred_dirs = torch.stack([torch.cos(pred_thetas), torch.sin(pred_thetas)], dim=-1)
        coef = _quad_coefficients(batch.agt_ctrs, batch.agt_dirs, pred_ctrs, pred_dirs, k)

        # Constant-acceleration arc-length reparameterization (lanercnn.py:851-865).
        steps = torch.arange(0, t_pred + 1, dtype=torch.float32, device=dev)
        trajs31 = _sample_traj((1.0 / t_pred) * steps[None, None, :], *coef)  # [B, k, 31, 2]
        seg_d = trajs31[:, :, 1:] - trajs31[:, :, :-1]
        curve_len = seg_d.square().sum(-1).sqrt().sum(-1)  # [B, k]
        accs = 2 * (curve_len - batch.agt_vels[:, None] * 3.0) / 9.0
        t31 = 0.1 * steps
        v = torch.clamp_min(batch.agt_vels[:, None, None] + accs[:, :, None] * t31, 0.0)
        s_abs = (v[:, :, 0:1] + v[:, :, 1:]) * t31[1:] / 2  # [B, k, 30]

        # Agent-motion-graph refinement (lanercnn.py:869-896).
        traj_pts = batch.agt_trajs.reshape(b * t_hist, 2)
        traj_dirs = batch.agt_traj_dirs.reshape(b * t_hist, 2)
        agt_feat = torch.relu(self.agt_layer1(traj_pts) + self.agt_layer2(traj_dirs))
        ctx_pose = torch.cat([traj_pts, traj_dirs], dim=-1)
        tgt_pose = torch.cat([anc_ctrs, anc_dirs], dim=-1)
        int_feats = _pool(self.lane_pool, self.remat, agt_feat, ctx_pose, int_feats, tgt_pose,
                          batch.a2r)

        traj_feats = int_feats[sel]  # [B, k, C]
        delta = self.refinement(traj_feats.reshape(b * k, -1)).reshape(b, k, t_pred, 2)

        # Longitudinal shift + renormalize (lanercnn.py:898-903).
        s_abs2 = s_abs + delta[:, :, :, 0]
        s_max2 = s_abs2.amax(2, keepdim=True)
        s_norm2 = torch.where(s_max2 != 0, s_abs2 / torch.where(s_max2 == 0, 1.0, s_max2), s_abs2)
        s_norm2 = torch.where(s_norm2 == 0.0, 1.0, s_norm2)
        # Lateral shift along the rotated tangent (lanercnn.py:904-919).
        dxy = _sample_d1_traj(s_norm2, *coef)  # [B, k, 30, 2]
        norm_dxy = torch.stack([-dxy[..., 1], dxy[..., 0]], dim=-1)
        trajs = _sample_traj(s_norm2, *coef) + norm_dxy * delta[:, :, :, 1:2]
        return pred_logits, pred_ctrs, trajs


class PredHead(nn.Module):
    """Standalone per-node 5-dim goal head (reference PredHead
    lanercnn.py:647-662, commented out of the reference Net: Decode's
    `pred` holds the same Linear + Dense). [nodes, n_map] → [nodes, 5]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pred = nn.Sequential(Linear(cfg.n_map, cfg.n_actor, dtype=dtype),
                                  Dense(cfg.n_actor, 5, dtype=dtype))

    def forward(self, roi_feat: torch.Tensor) -> torch.Tensor:
        return self.pred(roi_feat)


class RefineHead(nn.Module):
    """Standalone per-node refinement head (reference RefineHead
    lanercnn.py:664-680, commented out of the reference Net).
    [nodes, n_map] → [nodes, num_mods, num_preds, 2]."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.refinement = nn.Sequential(
            Linear(cfg.n_map, cfg.n_actor, dtype=dtype),
            Dense(cfg.n_actor, cfg.num_mods * cfg.num_preds * 2, dtype=dtype))

    def forward(self, roi_feat: torch.Tensor) -> torch.Tensor:
        return self.refinement(roi_feat).reshape(-1, self.cfg.num_mods, self.cfg.num_preds, 2)


class LaneRCNN(nn.Module):
    """The LaneRCNN Net with the reference's module names.

    dtype is the compute dtype (parameters stay fp32); device defaults to
    `cuda` (raises without CUDA unless device="cpu"); parameters are drawn
    from a torch.Generator seeded with `seed`; remat rematerializes the
    three LanePoolings in the backward (less memory, one more pooling
    forward each).
    """

    family = "lanercnn"  # its weight table (utils/weights.py TABLES)

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.input = LaneInput(cfg, dtype)
        self.roi_net1 = LaneRoI(cfg, dtype)
        self.interactor = Interactor(cfg, dtype, remat)
        self.roi_net2 = LaneRoI(cfg, dtype)
        self.decode = Decode(cfg, dtype, remat)
        init_parameters(self, seed)
        self.to(device)

    def forward(self, batch: RoiPackedBatch) -> Dict[str, torch.Tensor]:
        """pred_logics [B, K], pred_goals [B, K, 2], pred_trajs [B, K, T, 2]
        (agent frame), fp32."""
        plan = None
        if batch.plan_lu is not None:
            plan = (batch.plan_lu, batch.plan_lv, batch.plan_rel, batch.plan_scen)
        rel = (batch.edges, batch.bands, batch.tables, plan)
        feat = self.roi_net1(self.input(batch), *rel)
        feat = self.interactor(batch, feat)
        feat = self.roi_net2(feat, *rel)
        logits, goals, trajs = self.decode(feat, batch)
        return {"pred_logics": logits.float(), "pred_goals": goals.float(),
                "pred_trajs": trajs.float()}


def roi_loss(out: Dict[str, torch.Tensor], batch: RoiPackedBatch,
             cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """BCE mode classification + SmoothL1 goal/trajectory regression
    (reference RoiLoss lanercnn.py:1205-1301), masked for padding scenarios;
    sums with their support counts and the normalized `loss`."""
    logits, goals, trajs = out["pred_logics"], out["pred_goals"], out["pred_trajs"]
    gt, has, valid = batch.gt_preds, batch.has_preds, batch.scen_mask
    k, t = trajs.shape[1], trajs.shape[2]
    dev = trajs.device

    last = has.float() + 0.1 * torch.arange(t, dtype=torch.float32, device=dev) / float(t)
    last_idcs = last.argmax(1)  # [B], first maximum
    gt_last = torch.gather(gt, 1, last_idcs[:, None, None].expand(-1, 1, 2))[:, 0]
    dist = (goals - gt_last[:, None, :]).square().sum(-1).sqrt()  # [B, K]
    min_idcs = dist.argmin(1)

    # BCE-with-logits against the min-goal-dist one-hot (lanercnn.py:1260-1270).
    onehot = torch.nn.functional.one_hot(min_idcs, k).float()
    bce = torch.clamp_min(logits, 0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    cls_loss = torch.where(valid[:, None], bce, 0.0).sum()
    num_cls = valid.float().sum()

    # Goal regression on the best mode (lanercnn.py:1273-1284).
    has_goal = torch.gather(has, 1, last_idcs[:, None])[:, 0] & valid
    goal_best = torch.gather(goals, 1, min_idcs[:, None, None].expand(-1, 1, 2))[:, 0]
    reg_goal = cfg.reg_coef * torch.where(
        has_goal[:, None], smooth_l1(goal_best - gt_last), 0.0).sum()
    num_goal = has_goal.float().sum()

    # Trajectory regression on the best mode (lanercnn.py:1286-1294).
    traj_best = torch.gather(trajs, 1, min_idcs[:, None, None, None].expand(-1, 1, t, 2))[:, 0]
    traj_mask = has & valid[:, None]
    reg_traj = cfg.reg_coef * torch.where(
        traj_mask[:, :, None], smooth_l1(traj_best - gt), 0.0).sum()
    num_traj = traj_mask.float().sum()

    loss = (cls_loss / (num_cls + 1e-10) + reg_goal / (num_goal + 1e-10)
            + reg_traj / (num_traj + 1e-10))
    return {"loss": loss, "cls_loss": cls_loss, "num_cls": num_cls,
            "reg_loss": reg_goal + reg_traj, "num_reg": num_goal + num_traj,
            "reg_goal_loss": reg_goal, "num_reg_goal": num_goal,
            "reg_traj_loss": reg_traj, "num_reg_traj": num_traj}


def roi_loss_for_goals(out: Dict[str, torch.Tensor], batch: RoiPackedBatch,
                       cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Goal-only loss (reference RoiLossForGoals lanercnn.py:926-1202,
    superseded by RoiLoss on the active path): roi_loss's BCE and best-mode
    goal SmoothL1, no trajectory term; `goals_to_eval` [B, 2] is the best
    mode's goal."""
    logits, goals = out["pred_logics"], out["pred_goals"]
    gt, has, valid = batch.gt_preds, batch.has_preds, batch.scen_mask
    t, k = gt.shape[1], logits.shape[1]
    dev = gt.device

    last = has.float() + 0.1 * torch.arange(t, dtype=torch.float32, device=dev) / float(t)
    last_idcs = last.argmax(1)
    gt_last = torch.gather(gt, 1, last_idcs[:, None, None].expand(-1, 1, 2))[:, 0]
    min_idcs = (goals - gt_last[:, None, :]).square().sum(-1).sqrt().argmin(1)

    onehot = torch.nn.functional.one_hot(min_idcs, k).float()
    bce = torch.clamp_min(logits, 0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    cls_loss = torch.where(valid[:, None], bce, 0.0).sum()
    num_cls = valid.float().sum()

    has_goal = torch.gather(has, 1, last_idcs[:, None])[:, 0] & valid
    goal_best = torch.gather(goals, 1, min_idcs[:, None, None].expand(-1, 1, 2))[:, 0]
    reg_loss = cfg.reg_coef * torch.where(
        has_goal[:, None], smooth_l1(goal_best - gt_last), 0.0).sum()
    num_reg = has_goal.float().sum()

    loss = cls_loss / (num_cls + 1e-10) + reg_loss / (num_reg + 1e-10)
    return {"loss": loss, "cls_loss": cls_loss, "num_cls": num_cls, "reg_loss": reg_loss,
            "num_reg": num_reg, "goals_to_eval": goal_best}


def roi_metrics(out: Dict[str, torch.Tensor], batch: RoiPackedBatch) -> Dict[str, torch.Tensor]:
    """ADE/FDE/MR sums on the focal agent (agent frame; displacement metrics
    are rotation-invariant, reference lanercnn.py:1408-1463), with the
    scenario count."""
    trajs, gt = out["pred_trajs"], batch.gt_preds
    valid = batch.scen_mask.float()
    err = (trajs - gt[:, None]).square().sum(3).sqrt()  # [B, K, T]
    min_idcs = err[:, :, -1].argmin(1)
    err_best = torch.gather(err, 1, min_idcs[:, None, None].expand(-1, 1, err.shape[2]))[:, 0]
    return {"ade1_sum": (err[:, 0].mean(1) * valid).sum(),
            "fde1_sum": (err[:, 0, -1] * valid).sum(),
            "ade_sum": (err_best.mean(1) * valid).sum(),
            "fde_sum": (err_best[:, -1] * valid).sum(),
            "mr_sum": ((err_best[:, -1] > 2.0).float() * valid).sum(),
            "num_scen": valid.sum()}
