"""LaneGCN: top-level network, loss and metrics on packed batches.

Net pipeline (reference lanegcn.py:94-151):
    ActorNet ∥ MapNet → A2M → M2M → M2A → A2A → PredNet → world-frame transform

Loss (reference PredLoss lanegcn.py:740-807): max-margin mode classification
against the min-FDE mode + SmoothL1 regression on the best mode, masked and
returned as sums with their support counts.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from lanegcn_tpu_torch.config import LossConfig, ModelConfig
from lanegcn_tpu_torch.device import resolve_device
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.actor_net import ActorNet
from lanegcn_tpu_torch.models.fusion import A2A, A2M, M2A, M2M
from lanegcn_tpu_torch.models.layers import init_parameters
from lanegcn_tpu_torch.models.map_net import MapNet, graph_spill
from lanegcn_tpu_torch.models.pred_net import PredNet


class LaneGCN(nn.Module):
    """The LaneGCN Net with the reference's module names.

    dtype is the compute dtype (parameters stay fp32); device defaults to
    `cuda` (raises without CUDA unless device="cpu"); parameters are drawn
    from a torch.Generator seeded with `seed`.
    """

    family = "lanegcn"  # its weight table (utils/weights.py TABLES)

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        self.actor_net = ActorNet(cfg, dtype=dtype)
        self.map_net = MapNet(cfg, dtype=dtype)
        self.a2m = A2M(cfg, dtype=dtype)
        self.m2m = M2M(cfg, dtype=dtype)
        self.m2a = M2A(cfg, dtype=dtype)
        self.a2a = A2A(cfg, dtype=dtype)
        self.pred_net = PredNet(cfg, dtype=dtype)
        init_parameters(self, seed)
        self.to(device)

    def forward(self, batch: PackedBatch) -> Dict[str, torch.Tensor]:
        """Packed outputs: cls [A, K], reg [A, K, T, 2] (world frame), fp32."""
        actor_ctrs = batch.actors.ctrs
        actors = self.actor_net(batch.actors.feats.to(self.dtype))
        # The spill plan's preparation, once for MapNet's and M2M's stacks.
        spill = graph_spill(batch.graph, len(self.map_net.fuse.names))
        nodes = self.map_net(batch.graph, spill)
        fus = batch.fusion
        nodes = self.a2m(nodes, batch.graph, actors, actor_ctrs, fus.a2m, fus.pair_a2m)
        nodes = self.m2m(nodes, batch.graph, spill)
        actors = self.m2a(actors, actor_ctrs, nodes, batch.graph.ctrs, fus.m2a, fus.pair_m2a)
        actors = self.a2a(actors, actor_ctrs, fus.a2a, fus.pair_a2a)
        cls, reg = self.pred_net(actors, actor_ctrs)
        # Agent frame → world frame: w = a @ R + orig (reference lanegcn.py:146-150).
        rot = batch.rot[batch.actors.scen]
        orig = batch.orig[batch.actors.scen]
        reg = torch.einsum("aktc,acd->aktd", reg.float(), rot) + orig[:, None, None, :]
        return {"cls": cls.float(), "reg": reg}


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """torch nn.SmoothL1Loss elementwise (beta=1)."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def pred_loss(out: Dict[str, torch.Tensor], batch: PackedBatch,
              cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Masked static-shape PredLoss (reference lanegcn.py:740-807): returns
    unnormalized sums + support counts, and the normalized `loss`."""
    cls, reg = out["cls"], out["reg"]  # [A, K], [A, K, T, 2]
    gt = batch.gt_preds
    has = batch.has_preds
    t = reg.shape[2]
    dev = reg.device

    last = has.float() + 0.1 * torch.arange(t, dtype=torch.float32, device=dev) / float(t)
    max_last = last.amax(dim=1)
    last_idcs = last.argmax(dim=1)  # first maximum, as jnp.argmax
    valid = batch.actors.mask & (max_last > 1.0)

    reg_last = torch.gather(reg, 2, last_idcs[:, None, None, None].expand(-1, reg.shape[1], 1, 2))[:, :, 0]
    gt_last = torch.gather(gt, 1, last_idcs[:, None, None].expand(-1, 1, 2))[:, 0]
    dist = (reg_last - gt_last[:, None, :]).square().sum(2).sqrt()  # [A, K]
    min_dist = dist.amin(dim=1)
    min_idcs = dist.argmin(dim=1)  # first minimum, as jnp.argmin

    cls_best = torch.gather(cls, 1, min_idcs[:, None])
    mgn = cls_best - cls
    mask0 = (min_dist < cfg.cls_th)[:, None]
    mask1 = dist - min_dist[:, None] > cfg.cls_ignore
    sel = valid[:, None] & mask0 & mask1 & (mgn < cfg.mgn)
    num_cls = sel.float().sum()
    cls_loss = cfg.cls_coef * (cfg.mgn * num_cls - torch.where(sel, mgn, 0.0).sum())

    reg_best = torch.gather(
        reg, 1, min_idcs[:, None, None, None].expand(-1, 1, t, 2))[:, 0]  # [A, T, 2]
    reg_mask = valid[:, None] & has
    per_elem = smooth_l1(reg_best - gt)
    reg_loss = cfg.reg_coef * torch.where(reg_mask[:, :, None], per_elem, 0.0).sum()
    num_reg = reg_mask.float().sum()

    loss = cls_loss / (num_cls + 1e-10) + reg_loss / (num_reg + 1e-10)
    return {"loss": loss, "cls_loss": cls_loss, "num_cls": num_cls,
            "reg_loss": reg_loss, "num_reg": num_reg}


def agent_metrics(out: Dict[str, torch.Tensor], batch: PackedBatch) -> Dict[str, torch.Tensor]:
    """ADE/FDE/MR sums for each scenario's focal AGENT (reference
    pred_metrics lanegcn.py:883-899), with the scenario count."""
    reg = out["reg"][batch.agent_idx]  # [B, K, T, 2]
    gt = batch.gt_preds[batch.agent_idx]  # [B, T, 2]
    valid = batch.scen_mask.float()
    err = (reg - gt[:, None]).square().sum(3).sqrt()  # [B, K, T]
    ade1 = (err[:, 0].mean(1) * valid).sum()
    fde1 = (err[:, 0, -1] * valid).sum()
    min_idcs = err[:, :, -1].argmin(dim=1)
    err_best = torch.gather(err, 1, min_idcs[:, None, None].expand(-1, 1, err.shape[2]))[:, 0]
    ade = (err_best.mean(1) * valid).sum()
    fde = (err_best[:, -1] * valid).sum()
    mr = ((err_best[:, -1] > 2.0).float() * valid).sum()
    return {"ade1_sum": ade1, "fde1_sum": fde1, "ade_sum": ade, "fde_sum": fde,
            "mr_sum": mr, "num_scen": valid.sum()}
