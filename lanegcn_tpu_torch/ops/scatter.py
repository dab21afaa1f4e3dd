"""Masked gather / scatter-add over static-capacity edge lists."""

from __future__ import annotations

import torch


def masked_gather(x: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor | None = None):
    """Rows x[idx], indices clamped into range; rows where mask is False are
    zeroed (so clamping never leaks data). Returns [E, ...].

    The gather is an index_select, whose backward is one index_add_; padding
    slots read distinct rows (and are zeroed), so the backward does not pile
    every padding slot onto one row (advanced indexing's backward sorts the
    indices and walks each run of equal ones serially: with all padding on
    row 0 that took ~1.9 s per S=256 train step on an H100).
    """
    n = x.shape[0]
    flat = idx.reshape(-1).clamp(0, n - 1)
    if mask is not None:
        spread = torch.arange(flat.shape[0], device=flat.device) % n
        flat = torch.where(mask.reshape(-1), flat, spread)
    out = x.index_select(0, flat).reshape(idx.shape + x.shape[1:])
    if mask is not None:
        out = torch.where(mask.reshape(mask.shape + (1,) * (out.dim() - mask.dim())), out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return out


def scatter_add(
    data: torch.Tensor,
    idx: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[idx[e]] += data[e] for valid edges; masked edges are dropped.

    Returns a new tensor (out is not modified). Uses index_add_, whose sum
    order on CUDA depends on its atomics, so the result is not bitwise
    deterministic there.
    """
    if out is None:
        out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                          device=data.device)
    if mask is not None:
        keep = mask.nonzero().squeeze(1)
        idx, data = idx[keep], data[keep]
    return out.clone().index_add_(0, idx, data.to(out.dtype))
