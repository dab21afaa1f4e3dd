"""BEV raster feature sampling: bilinear pixel and rotated-RoI extraction,
the port's counterpart of lanegcn_tpu/ops/roi.py (the reference's legacy
raster path, layers.py:249-353: linear_interp, get_pixel_feat,
get_roi_feat), in plain PyTorch on the tensors' device.

Feature maps are [C, H, W], the layout the reference's functions take (one
sample of an NCHW map); the JAX package takes [H, W, C]. Row 0 of a map is
its top (largest y), as RasterMapQuery's cartesian flip leaves it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def linear_interp(x: torch.Tensor, n_max: int):
    """Normalized positions [0, 1] → (left weight, left index, right weight,
    right index) for centre-aligned pixels, indices clamped into
    [0, n_max - 1] (reference layers.py:249-274)."""
    x = (x * n_max - 0.5).clamp(0.0, n_max - 1)
    n = torch.floor(x)
    rw = x - n
    lw = 1.0 - rw
    li = n.long()
    ri = (li + 1).clamp_max(n_max - 1)
    return lw, li, rw, ri


def _bilinear(fm: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """fm [C, H, W] sampled at normalized (xs, ys) [M] → [M, C]."""
    h, w = fm.shape[1], fm.shape[2]
    hwc = fm.permute(1, 2, 0)
    xlw, xli, xhw, xhi = linear_interp(xs, w)
    ylw, yli, yhw, yhi = linear_interp(ys, h)
    return (
        (xlw * ylw)[:, None] * hwc[yli, xli]
        + (xlw * yhw)[:, None] * hwc[yhi, xli]
        + (xhw * ylw)[:, None] * hwc[yli, xhi]
        + (xhw * yhw)[:, None] * hwc[yhi, xhi]
    )


def get_pixel_feat(
    fm: torch.Tensor,  # [C, H, W]
    points: torch.Tensor,  # [N, 2] world xy
    pts_range: Sequence[float],  # (x_min, x_max, y_min, y_max)
) -> torch.Tensor:
    """Bilinear feature sampling at world points → [N, C] (reference
    layers.py:277-291)."""
    x_min, x_max, y_min, y_max = pts_range[:4]
    x = (points[:, 0] - x_min) / (x_max - x_min)
    y = (y_max - points[:, 1]) / (y_max - y_min)
    return _bilinear(fm, x, y)


def get_roi_feat(
    fm: torch.Tensor,  # [C, H, W]
    bboxes: torch.Tensor,  # [N, 5] (cx, cy, wid, hgt, theta)
    roi_size: int | Tuple[int, int],
    pts_range: Sequence[float],
) -> torch.Tensor:
    """Rotated-box RoI feature extraction (reference layers.py:294-353):
    each box's roi_h x roi_w bin centres, rotated by theta about (cx, cy),
    sampled bilinearly. Returns [N, C, roi_h, roi_w] (NCHW, what the 2-D
    blocks take); bins outside the range are zero."""
    if isinstance(roi_size, int):
        roi_size = (roi_size, roi_size)
    roi_h, roi_w = roi_size
    n = bboxes.shape[0]
    cx, cy, wid, hgt, theta = bboxes.unbind(1)
    ct, st = torch.cos(theta), torch.sin(theta)

    dev, dt = bboxes.device, bboxes.dtype
    x_bin = (torch.arange(roi_w, device=dev, dtype=dt) + 0.5) / roi_w - 0.5  # [W]
    y_bin = (torch.arange(roi_h - 1, -1, -1, device=dev, dtype=dt) + 0.5) / roi_h - 0.5  # top-down
    ox = x_bin[None, None, :] * wid[:, None, None]  # [N, 1, W]
    oy = y_bin[None, :, None] * hgt[:, None, None]  # [N, H, 1]
    c, s = ct[:, None, None], st[:, None, None]
    px = (c * ox - s * oy) + cx[:, None, None]  # [N, H, W]
    py = (s * ox + c * oy) + cy[:, None, None]

    x_min, x_max, y_min, y_max = pts_range[:4]
    xs = (px.reshape(-1) - x_min) / (x_max - x_min)
    ys = (y_max - py.reshape(-1)) / (y_max - y_min)
    valid = (xs > 0) & (xs < 1) & (ys > 0) & (ys < 1)
    feat = _bilinear(fm, xs, ys)
    feat = torch.where(valid[:, None], feat, torch.zeros((), dtype=feat.dtype, device=dev))
    return feat.reshape(n, roi_h, roi_w, fm.shape[0]).permute(0, 3, 1, 2).contiguous()
