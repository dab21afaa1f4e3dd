"""GroupNorm with torch semantics on channels-last input.

Statistics are taken in fp32 with biased variance and eps inside the
rsqrt, per sample over all non-batch dims of each group (ng=1 in practice,
so per-row normalization that never mixes packed rows).
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
