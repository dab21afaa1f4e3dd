"""Fused LaneConv residual layer (forward): the `lane_layer` CUDA kernel
(csrc/lane_layer.cu) and its plain PyTorch version.

    temp = pre + Σ_j band_j ⊙ feat[u + s_j] @ Wb_j     (rows outside [0, N) read 0)
    out  = relu(GN2(relu(GN1(temp)) @ W2) + feat)

Counterpart of lanegcn_tpu/ops/pallas_lane_layer.py `fused_lane_layer`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import group_norm

HALO = 32


def _shift_rows(x: torch.Tensor, s: int) -> torch.Tensor:
    """rows[u] = x[u + s], zero where u + s falls outside [0, N)."""
    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, HALO, HALO))
    return xp[HALO + s : HALO + s + n]


def lane_layer_plain(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b,
                     shifts: Sequence[int], eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 products of dtype-valued
    operands; h rounded to the activation dtype before the second product."""
    dt = feat.dtype
    f = feat.float()
    temp = pre.float()
    for j, s in enumerate(shifts):
        rows = _shift_rows(f, s) * masks[j].to(torch.float32)[:, None]
        temp = temp + rows @ wb[j].float()
    h = torch.relu(group_norm(temp, g1w, g1b, 1, eps)).to(dt).float()
    z = h @ w2.float()
    y = group_norm(z, g2w, g2b, 1, eps)
    return torch.relu(y + f).to(dt)


def fused_lane_layer(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b,
                     shifts: Sequence[int], eps: float = 1e-5) -> torch.Tensor:
    """relu(GN2(relu(GN1(pre + band_conv(feat))) @ w2) + feat).

    feat/pre [N, 128] (float32 or bfloat16); masks [J, N] bool or 0/1;
    wb [J, 128, 128] and w2 [128, 128] in (in, out) layout, in feat's dtype;
    GN affines [128] fp32; shifts: J ints with |s| ≤ 32. CPU tensors take
    the plain version; CUDA tensors launch the kernel.
    """
    if feat.device.type == "cpu":
        return lane_layer_plain(feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, shifts, eps)
    if feat.device.type != "cuda":
        raise ValueError(f"lane_layer: unsupported device {feat.device}")
    n, c = feat.shape
    j = len(shifts)
    if (c != 128 or pre.shape != feat.shape or tuple(wb.shape) != (j, c, c)
            or tuple(w2.shape) != (c, c) or tuple(masks.shape) != (j, n)
            or any(tuple(g.shape) != (c,) for g in (g1w, g1b, g2w, g2b))):
        raise ValueError(f"lane_layer: bad shapes feat {feat.shape} pre {pre.shape} "
                         f"masks {masks.shape} wb {wb.shape} w2 {w2.shape}")
    if any(abs(s) > HALO for s in shifts):
        raise ValueError(f"lane_layer: shifts beyond ±{HALO}: {shifts}")
    if pre.dtype != feat.dtype or wb.dtype != feat.dtype or w2.dtype != feat.dtype:
        raise TypeError("lane_layer: feat, pre, wb and w2 must share one dtype")
    if masks.dtype == torch.bool:
        masks = masks.view(torch.uint8)
    elif masks.dtype != torch.uint8:
        masks = (masks != 0).to(torch.uint8)
    gns = [g.float().contiguous() for g in (g1w, g1b, g2w, g2b)]
    code = cuda.check_cuda("lane_layer", feat, pre, masks, wb, w2, *gns)
    out = torch.empty_like(feat)
    sh = (ctypes.c_int * max(j, 1))(*shifts)
    cuda.call(
        "lane_layer", "lane_layer_fwd",
        cuda.ptr(feat), cuda.ptr(pre), cuda.ptr(masks), cuda.ptr(wb), cuda.ptr(w2),
        *(cuda.ptr(g) for g in gns), cuda.ptr(out),
        ctypes.c_int(n), ctypes.c_int(j), ctypes.cast(sh, ctypes.c_void_p),
        ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return out


def work(feat, masks) -> dict:
    """Bytes the function must move and operations it does at these inputs:
    feat, pre and out whole, the masks as bytes, the weights once; a band
    product only on the rows its mask selects (the work depends on the
    masks' data), the second product on every row."""
    n, c = feat.shape
    j, db = masks.shape[0], feat.element_size()
    band_rows = int(torch.count_nonzero(masks))
    return {
        "bytes": 3 * n * c * db + j * n + (j + 1) * c * c * db + 4 * c * 4,
        "flops": 2 * c * c * (band_rows + n),
        "band_rows": band_rows,
    }
