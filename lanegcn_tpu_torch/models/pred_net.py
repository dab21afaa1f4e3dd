"""PredNet: multi-modal trajectory header (reference lanegcn.py:575-737).

Six LinearRes regression branches, destination attention for mode scoring,
and per-actor confidence-descending mode order (a stable sort, as
jnp.argsort is: tied scores keep their mode order).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from lanegcn_tpu_torch.config import ModelConfig
from lanegcn_tpu_torch.models.layers import Dense, Linear, LinearRes


class AttDest(nn.Module):
    """Destination attention (reference lanegcn.py:713-737)."""

    def __init__(self, n_agt: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dist = nn.Sequential(
            Dense(2, n_agt, dtype=dtype), nn.ReLU(), Linear(n_agt, n_agt, dtype=dtype)
        )
        self.agt = Linear(2 * n_agt, n_agt, dtype=dtype)

    def forward(self, agts, agt_ctrs, dest_ctrs):
        """agts [A, C], agt_ctrs [A, 2], dest_ctrs [A, K, 2] → [A*K, C]."""
        num_mods = dest_ctrs.shape[1]
        d = (agt_ctrs[:, None, :] - dest_ctrs).reshape(-1, 2)
        dist = self.dist(d)
        rep = agts.repeat_interleave(num_mods, dim=0)
        return self.agt(torch.cat([dist, rep.to(dist.dtype)], dim=-1))


class PredNet(nn.Module):
    """Multi-modal prediction head (reference lanegcn.py:575-631)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        c, t = cfg.n_actor, cfg.num_preds
        self.pred = nn.ModuleList([
            nn.Sequential(LinearRes(c, c, dtype=dtype), Dense(c, 2 * t, dtype=dtype))
            for _ in range(cfg.num_mods)
        ])
        self.att_dest = AttDest(c, dtype=dtype)
        self.cls = nn.Sequential(LinearRes(c, c, dtype=dtype), Dense(c, 1, dtype=dtype))

    def forward(self, actors, actor_ctrs) -> Tuple[torch.Tensor, torch.Tensor]:
        """actors [A, C], actor_ctrs [A, 2] → (cls [A, K], reg [A, K, T, 2]),
        reg in the agent frame, modes sorted by descending confidence."""
        k, t = self.cfg.num_mods, self.cfg.num_preds
        reg = torch.stack([p(actors) for p in self.pred], dim=1)
        reg = reg.reshape(actors.shape[0], k, t, 2) + actor_ctrs[:, None, None, :]
        dest_ctrs = reg[:, :, -1].detach()
        feats = self.att_dest(actors, actor_ctrs, dest_ctrs)
        cls = self.cls(feats).reshape(-1, k)
        order = torch.argsort(-cls, dim=1, stable=True)
        cls = torch.gather(cls, 1, order)
        reg = torch.gather(reg, 1, order[:, :, None, None].expand(-1, -1, t, 2))
        return cls, reg
