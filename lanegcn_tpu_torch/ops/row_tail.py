"""Fused residual row tail, K = 1 (forward): the `row_tail` CUDA kernel
(csrc/row_tail.cu) and its plain version.

    out = relu(GN2(relu(GN1(x)) @ W) + res)

Counterpart of lanegcn_tpu/ops/pallas_row_tail.py `fused_row_tail`.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import group_norm


def row_tail_plain(x, res, w, g1w, g1b, g2w, g2b, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: h rounded to x's dtype, fp32
    product and statistics, one rounding of the output."""
    dt = x.dtype
    h = torch.relu(group_norm(x, g1w, g1b, 1, eps)).to(dt).float()
    z = h @ w.to(dt).float()
    y = group_norm(z, g2w, g2b, 1, eps)
    return torch.relu(y + res.float()).to(dt)


def fused_row_tail(x, res, w, g1w, g1b, g2w, g2b, eps: float = 1e-5) -> torch.Tensor:
    """x/res [N, 128] in one dtype; w [128, 128] (in, out), cast to x's
    dtype; GN affines [128] fp32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return row_tail_plain(x, res, w, g1w, g1b, g2w, g2b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"row_tail: unsupported device {x.device}")
    n, c = x.shape
    if (c != 128 or res.shape != x.shape or tuple(w.shape) != (c, c)
            or any(tuple(g.shape) != (c,) for g in (g1w, g1b, g2w, g2b))):
        raise ValueError(f"row_tail: bad shapes x {x.shape} res {res.shape} w {w.shape}")
    if res.dtype != x.dtype:
        raise TypeError("row_tail: x and res must share one dtype")
    w = w.to(x.dtype).contiguous()
    gns = [g.float().contiguous() for g in (g1w, g1b, g2w, g2b)]
    code = cuda.check_cuda("row_tail", x, res, w, *gns)
    out = torch.empty_like(x)
    cuda.call(
        "row_tail", "row_tail_fwd",
        cuda.ptr(x), cuda.ptr(res), cuda.ptr(w), *(cuda.ptr(g) for g in gns), cuda.ptr(out),
        ctypes.c_int(n), ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return out


def work(n: int, itemsize: int) -> dict:
    c = 128
    return {"bytes": 3 * n * c * itemsize + c * c * itemsize + 4 * c * 4,
            "flops": 2 * n * c * c}
