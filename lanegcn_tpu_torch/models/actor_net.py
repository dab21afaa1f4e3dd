"""ActorNet: 1-D conv FPN over trajectory histories (reference
lanegcn.py:212-263): three groups of two Res1d blocks (32/64/128 channels,
stride-2 downsampling 20→10→5), 3-wide lateral convs, linear top-down
upsampling with additive merge, a final Res1d, and the last timestep as
the actor embedding. Input is channels-last [A, T_hist, 3]."""

from __future__ import annotations

import torch
from torch import nn

from lanegcn_tpu_torch.config import ModelConfig
from lanegcn_tpu_torch.models.layers import Conv1dBlock, Res1d
from lanegcn_tpu_torch.ops import interpolate_linear


class ActorNet(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        n_out = (32, 64, cfg.n_actor)
        groups = []
        n_in = 3
        for i, ch in enumerate(n_out):
            stride = 1 if i == 0 else 2
            groups.append(nn.Sequential(
                Res1d(n_in, ch, stride=stride, dtype=dtype),
                Res1d(ch, ch, dtype=dtype),
            ))
            n_in = ch
        self.groups = nn.ModuleList(groups)
        self.lateral = nn.ModuleList(
            [Conv1dBlock(ch, cfg.n_actor, act=False, dtype=dtype) for ch in n_out]
        )
        self.output = Res1d(cfg.n_actor, cfg.n_actor, dtype=dtype)

    def forward(self, actor_feats: torch.Tensor) -> torch.Tensor:
        """[A, T_hist, 3] → [A, n_actor]."""
        out = actor_feats
        outputs = []
        for group in self.groups:
            out = group(out)
            outputs.append(out)
        out = self.lateral[-1](outputs[-1])
        for i in range(len(outputs) - 2, -1, -1):
            out = interpolate_linear(out, out.shape[1] * 2)
            out = out + self.lateral[i](outputs[i])
        out = self.output(out)
        return out[:, -1, :]
