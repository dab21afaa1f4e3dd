"""1-D convolution and linear interpolation, channels-last ([N, L, C])."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """torch Conv1d(padding=(K-1)//2, bias=False) on channels-last input.

    x: [N, L, C_in]; w: [C_out, C_in, K] (torch layout). Returns [N, L', C_out].
    """
    k = w.shape[-1]
    y = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=(k - 1) // 2)
    return y.transpose(1, 2)


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode="linear", align_corners=False) along L of [N, L, C].

    Source coordinate of output i is (i + 0.5) * L/out_len - 0.5, clamped to
    [0, L-1]; values blend the floor/ceil neighbours.
    """
    l_in = x.shape[1]
    scale = l_in / out_len
    coords = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    coords = coords.clamp(0.0, l_in - 1)
    lo = coords.floor().long()
    hi = (lo + 1).clamp(max=l_in - 1)
    w_hi = (coords - lo.float()).to(x.dtype)
    x_lo = x[:, lo]
    x_hi = x[:, hi]
    return x_lo + (x_hi - x_lo) * w_hi[None, :, None]
