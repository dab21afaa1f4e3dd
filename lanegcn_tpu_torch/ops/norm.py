"""GroupNorm with torch semantics on channels-last input.

Statistics are taken in fp32 with biased variance and eps inside the
rsqrt, per sample over all non-batch dims of each group (ng=1 in practice,
so per-row normalization that never mixes packed rows). `gn_stats` and
`gn_bwd` are the pieces the kernels' plain backward versions are written in.
"""

from __future__ import annotations

import math

import torch


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 1,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x: [N, C] or [N, L, C] (channels last); weight/bias: [C]. Returns fp32."""
    c = x.shape[-1]
    assert c % num_groups == 0, (c, num_groups)
    shape = x.shape
    spatial = math.prod(shape[1:-1])
    xg = x.float().reshape(shape[0], spatial, num_groups, c // num_groups)
    xg = xg.transpose(1, 2)  # [N, G, S, C/G]
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.transpose(1, 2).reshape(shape)
    return out * weight.float() + bias.float()


def gn_stats(t: torch.Tensor, eps: float = 1e-5):
    """Single-group GroupNorm of fp32 rows [N, C]: (normalized rows, 1/std [N, 1])."""
    mu = t.mean(1, keepdim=True)
    inv = torch.rsqrt((t - mu).square().mean(1, keepdim=True) + eps)
    return (t - mu) * inv, inv


def gn_bwd(d_y: torch.Tensor, nrm: torch.Tensor, inv: torch.Tensor,
           weight: torch.Tensor) -> torch.Tensor:
    """Backward of `nrm * weight + b` through the normalization, per row:
    inv · (d_nrm − mean(d_nrm) − nrm · mean(d_nrm · nrm)), d_nrm = d_y ⊙ weight."""
    d_nrm = d_y * weight.float()
    c1 = d_nrm.mean(1, keepdim=True)
    c2 = (d_nrm * nrm).mean(1, keepdim=True)
    return inv * (d_nrm - c1 - nrm * c2)
