"""Fused residual row tails: the `row_tail` CUDA kernels (csrc/row_tail.cu)
and their plain versions.

    K = 1:  out = relu(GN2(relu(GN1(x)) @ W) + res)
    K = 2:  out = relu(GN3(relu(GN2(relu(GN1(x)) @ W1)) @ W2) + res)

Counterparts of lanegcn_tpu/ops/pallas_row_tail.py `fused_row_tail` (Att's
tail) and `fused_row_tail2` (LaneRCNN's LanePooling tail). Both run
through a `torch.autograd.Function`: the backward is the `row_tail_bwd`
(K = 1) or `row_tail2_bwd` (K = 2) kernel on CUDA tensors and
`row_tail_bwd_plain` / `row_tail2_bwd_plain` on CPU tensors.

The kernels take rows W = 128 or 64 wide (K = 1: Att's tail on 128-wide
lane nodes, and on 64-wide actors where n_actor = 64; K = 2: LanePooling's
tail at n_map = 128 or 64); K = 1 also takes 256 both ways (the
double-width model, csrc/wide.cuh and csrc/wide_bwd.cuh). The plain versions
take any width.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats, group_norm

C = 128


def part_size(c: int) -> int:
    """A K = 1 backward partial at width c: dW, dg1w, dg1b, dg2w, dg2b."""
    return c * c + 4 * c


def wide_part_floats(n: int, blocks: int, itemsize: int, c: int = 256) -> int:
    """The fp32 workspace of the 256-wide row tail's backward, as
    csrc/wide_bwd.cuh `launch_tail_bwd` carves it: the row pass's vector
    partials (blocks x 4c), the
    weight-gradient pass's partials (max(1, blocks // 2) splits x c²), then
    the h and rnd(d_z) workspaces ([n, c] each in the activation dtype)."""
    return blocks * 4 * c + max(1, blocks // 2) * c * c + (2 * n * c * itemsize + 15) // 16 * 4


def part2_size(c: int) -> int:
    """A K = 2 backward partial at width c: dW1, dW2, then the three GNs'
    weight and bias."""
    return 2 * c * c + 6 * c


def row_tail_plain(x, res, w, g1w, g1b, g2w, g2b, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: h rounded to x's dtype, fp32
    product and statistics, one rounding of the output."""
    dt = x.dtype
    h = torch.relu(group_norm(x, g1w, g1b, 1, eps)).to(dt).float()
    z = h @ w.to(dt).float()
    y = group_norm(z, g2w, g2b, 1, eps)
    return torch.relu(y + res.float()).to(dt)


def tail_bwd_plain(x, res, w, g1w, g1b, g2w, g2b, g, eps: float = 1e-5):
    """Backward of relu(GN2(relu(GN1(x)) @ w) + res) with the kernels'
    rounding points (h and d_z rounded to res's dtype before the products).

    x may be fp32 (the lane layer's saved temp) or res's dtype. Returns fp32
    (d_x, d_y, dW, dg1w, dg1b, dg2w, dg2b); d_y is the cotangent of res.
    """
    dt = res.dtype
    nrm1, inv1 = gn_stats(x.float(), eps)
    h_pre = nrm1 * g1w.float() + g1b.float()
    h = torch.relu(h_pre).to(dt).float()
    wf = w.to(dt).float()
    nrm2, inv2 = gn_stats(h @ wf, eps)
    y = nrm2 * g2w.float() + g2b.float()
    d_y = torch.where(y + res.float() > 0, g.to(dt).float(), 0.0)
    d_z = gn_bwd(d_y, nrm2, inv2, g2w).to(dt).float()
    d_h = torch.where(h_pre > 0, d_z @ wf.t(), 0.0)
    d_x = gn_bwd(d_h, nrm1, inv1, g1w)
    return (d_x, d_y, h.t() @ d_z, (d_h * nrm1).sum(0), d_h.sum(0),
            (d_y * nrm2).sum(0), d_y.sum(0))


def row_tail_bwd_plain(x, res, w, g1w, g1b, g2w, g2b, g, eps: float = 1e-5):
    """The backward kernel's arithmetic: (dx, dres) in x's dtype, then fp32
    dW [W, W] (in, out) and the four GN vector gradients."""
    d_x, d_y, *grads = tail_bwd_plain(x, res, w, g1w, g1b, g2w, g2b, g, eps)
    return (d_x.to(x.dtype), d_y.to(x.dtype), *grads)


def _check(x, res, w, gns, name="row_tail"):
    """Shapes and dtypes kernel `name` takes: x/res [N, W] with W in
    `cuda.WIDTHS` for `name`, w [W, W], the GN vectors [W]."""
    n, c = x.shape
    cuda.check_width(name, c)
    if (res.shape != x.shape or tuple(w.shape) != (c, c)
            or any(tuple(g.shape) != (c,) for g in gns)):
        raise ValueError(f"row_tail: bad shapes x {x.shape} res {res.shape} w {w.shape}")
    if res.dtype != x.dtype or w.dtype != x.dtype:
        raise TypeError("row_tail: x, res and w must share one dtype")


def _fwd_cuda(x, res, w, g1w, g1b, g2w, g2b, eps):
    _check(x, res, w, (g1w, g1b, g2w, g2b))
    w = cuda.param(w, x.dtype)
    gns = [cuda.param(g) for g in (g1w, g1b, g2w, g2b)]
    code = cuda.check_cuda("row_tail", x, res, w, *gns)
    out = torch.empty_like(x)
    cuda.call(
        "row_tail", "row_tail_fwd",
        cuda.ptr(x), cuda.ptr(res), cuda.ptr(w), *(cuda.ptr(g) for g in gns), cuda.ptr(out),
        ctypes.c_int(x.shape[0]), ctypes.c_int(x.shape[1]), ctypes.c_float(eps),
        ctypes.c_int(code), cuda.stream(),
    )
    return out


def row_tail_bwd_cuda(x, res, w, g1w, g1b, g2w, g2b, g, eps: float = 1e-5):
    """The `row_tail_bwd` kernel; the same outputs as `row_tail_bwd_plain`.
    At W = 256 its workspace also holds h and rnd(d_z) ([N, W] each, for
    the weight-gradient pass; `wide_part_floats`)."""
    _check(x, res, w, (g1w, g1b, g2w, g2b), "row_tail_bwd")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"row_tail: cotangent {g.shape} {g.dtype} for x {x.shape} {x.dtype}")
    w = cuda.param(w, x.dtype)
    gns = [cuda.param(t) for t in (g1w, g1b, g2w, g2b)]
    code = cuda.check_cuda("row_tail", x, res, g, w, *gns)
    blocks = cuda.num_sms(x.device)
    n, c = x.shape
    dx, dres = torch.empty_like(x), torch.empty_like(x)
    floats = (wide_part_floats(n, blocks, x.element_size()) if c == 256
              else blocks * part_size(c))
    part = torch.empty(floats, dtype=torch.float32, device=x.device)
    grads = torch.empty(part_size(c), dtype=torch.float32, device=x.device)
    cuda.call(
        "row_tail", "row_tail_bwd",
        cuda.ptr(x), cuda.ptr(res), cuda.ptr(g), cuda.ptr(w), *(cuda.ptr(t) for t in gns),
        cuda.ptr(dx), cuda.ptr(dres), cuda.ptr(part), cuda.ptr(grads),
        ctypes.c_int(n), ctypes.c_int(c), ctypes.c_int(blocks), ctypes.c_float(eps),
        ctypes.c_int(code), cuda.stream(),
    )
    dgn = grads[c * c:].view(4, c)
    return dx, dres, grads[: c * c].view(c, c), dgn[0], dgn[1], dgn[2], dgn[3]


class _RowTail(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `row_tail_bwd_plain` / `row_tail_bwd_cuda` likewise; each
    cotangent comes back in its primal's dtype."""

    @staticmethod
    def forward(ctx, x, res, w, g1w, g1b, g2w, g2b, eps):
        ctx.save_for_backward(x, res, w, g1w, g1b, g2w, g2b)
        ctx.eps = eps
        if x.device.type == "cpu":
            return row_tail_plain(x, res, w, g1w, g1b, g2w, g2b, eps)
        return _fwd_cuda(x, res, w, g1w, g1b, g2w, g2b, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x = saved[0]
        bwd = row_tail_bwd_plain if x.device.type == "cpu" else row_tail_bwd_cuda
        grads = bwd(*saved, g.to(x.dtype).contiguous(), ctx.eps)
        return (*(d.to(p.dtype) for d, p in zip(grads, saved)), None)


def fused_row_tail(x, res, w, g1w, g1b, g2w, g2b, eps: float = 1e-5) -> torch.Tensor:
    """x/res [N, W] in one dtype (W = 128, 64 or 256 on the card); w [W, W]
    (in, out), cast to x's dtype (its
    gradient flows back through the cast); GN affines [W] fp32. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_tail: unsupported device {x.device}")
    w = w.to(x.dtype)
    return _RowTail.apply(x.contiguous(), res.contiguous(), w.contiguous(), g1w, g1b, g2w, g2b,
                          eps)


def row_tail2_plain(x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b,
                    eps: float = 1e-5) -> torch.Tensor:
    """The K = 2 kernel's arithmetic: h1 and h2 rounded to x's dtype, fp32
    products and statistics, one rounding of the output."""
    dt = x.dtype
    h = torch.relu(group_norm(x, g1w, g1b, 1, eps)).to(dt).float()
    t = h @ w1.to(dt).float()
    h = torch.relu(group_norm(t, g2w, g2b, 1, eps)).to(dt).float()
    t = h @ w2.to(dt).float()
    y = group_norm(t, g3w, g3b, 1, eps)
    return torch.relu(y + res.float()).to(dt)


def row_tail2_bwd_plain(x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b, g,
                        eps: float = 1e-5):
    """The K = 2 backward kernel's arithmetic: the chain recomputed, then
    back through GN3, W2, GN2, W1 and GN1 with h1, h2 and each d_t rounded
    to x's dtype before their products. Returns (dx, dres) in x's dtype,
    then fp32 dW1, dW2 [W, W] (in, out) and the six GN vector
    gradients: one gradient per input, in the inputs' order."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    w1f, w2f = rnd(w1), rnd(w2)
    nrm1, inv1 = gn_stats(x.float(), eps)
    h1_pre = nrm1 * g1w.float() + g1b.float()
    h1 = rnd(torch.relu(h1_pre))
    nrm2, inv2 = gn_stats(h1 @ w1f, eps)
    h2_pre = nrm2 * g2w.float() + g2b.float()
    h2 = rnd(torch.relu(h2_pre))
    nrm3, inv3 = gn_stats(h2 @ w2f, eps)
    y = nrm3 * g3w.float() + g3b.float()
    d_y = torch.where(y + res.float() > 0, g.float(), 0.0)
    d_t2 = rnd(gn_bwd(d_y, nrm3, inv3, g3w))
    d_h2 = torch.where(h2_pre > 0, d_t2 @ w2f.t(), 0.0)
    d_t1 = rnd(gn_bwd(d_h2, nrm2, inv2, g2w))
    d_h1 = torch.where(h1_pre > 0, d_t1 @ w1f.t(), 0.0)
    d_x = gn_bwd(d_h1, nrm1, inv1, g1w)
    return (d_x.to(dt), d_y.to(dt), h1.t() @ d_t1, h2.t() @ d_t2,
            (d_h1 * nrm1).sum(0), d_h1.sum(0), (d_h2 * nrm2).sum(0), d_h2.sum(0),
            (d_y * nrm3).sum(0), d_y.sum(0))


def _check2(x, res, w1, w2, gns, name="row_tail2"):
    """The K = 2 kernels' weights as they read them and the six GN affines
    stacked [6, W] fp32."""
    for w in (w1, w2):
        _check(x, res, w, gns, name=name)
    return cuda.param(w1, x.dtype), cuda.param(w2, x.dtype), torch.stack([g.float() for g in gns])


def _fwd2_cuda(x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b, eps):
    w1, w2, gn = _check2(x, res, w1, w2, (g1w, g1b, g2w, g2b, g3w, g3b))
    code = cuda.check_cuda("row_tail", x, res, w1, w2, gn)
    out = torch.empty_like(x)
    cuda.call(
        "row_tail", "row_tail2_fwd",
        cuda.ptr(x), cuda.ptr(res), cuda.ptr(w1), cuda.ptr(w2), cuda.ptr(gn), cuda.ptr(out),
        ctypes.c_int(x.shape[0]), ctypes.c_int(x.shape[1]), ctypes.c_float(eps),
        ctypes.c_int(code), cuda.stream(),
    )
    return out


def row_tail2_bwd_cuda(x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b, g, eps: float = 1e-5):
    """The `row_tail2_bwd` kernel; the same outputs as `row_tail2_bwd_plain`.

    In bf16 it runs two passes: the chain pass writes rnd(d_t1) and
    rnd(d_t2) to a [2, N, W] bf16 workspace (2·N·4W bytes, freed on
    return), which the weight-gradient pass reads beside x. The row tensors
    go in 16-byte aligned (the bf16 passes copy them by cp.async)."""
    w1, w2, gn = _check2(x, res, w1, w2, (g1w, g1b, g2w, g2b, g3w, g3b), "row_tail2_bwd")
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"row_tail: cotangent {g.shape} {g.dtype} for x {x.shape} {x.dtype}")
    x, res, g = (cuda.param(t, t.dtype) for t in (x, res, g))
    code = cuda.check_cuda("row_tail", x, res, g, w1, w2, gn)
    blocks = cuda.num_sms(x.device)
    n, c = x.shape
    dx, dres = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty(blocks * part2_size(c), dtype=torch.float32, device=x.device)
    grads = torch.empty(part2_size(c), dtype=torch.float32, device=x.device)
    dt = torch.empty(2, n, c, dtype=x.dtype, device=x.device) if x.dtype == torch.bfloat16 else None
    cuda.call(
        "row_tail", "row_tail2_bwd",
        cuda.ptr(x), cuda.ptr(res), cuda.ptr(g), cuda.ptr(w1), cuda.ptr(w2), cuda.ptr(gn),
        cuda.ptr(dx), cuda.ptr(dres), cuda.ptr(part), cuda.ptr(grads), cuda.ptr(dt),
        ctypes.c_int(n), ctypes.c_int(c), ctypes.c_int(blocks), ctypes.c_float(eps),
        ctypes.c_int(code), cuda.stream(),
    )
    mats = grads[:2 * c * c].view(2, c, c)
    dgn = grads[2 * c * c:].view(6, c)
    return (dx, dres, mats[0], mats[1], *dgn.unbind(0))


class _RowTail2(torch.autograd.Function):
    """K = 2, as `_RowTail`: the plain versions on CPU tensors, the kernels
    on CUDA tensors; each cotangent in its primal's dtype."""

    @staticmethod
    def forward(ctx, x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b, eps):
        args = (x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b)
        out = (row_tail2_plain if x.device.type == "cpu" else _fwd2_cuda)(*args, eps)
        # Saved after the launch: a checkpointed recompute stops at the
        # region's last save, so the kernel runs again before it.
        ctx.save_for_backward(*args)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x = saved[0]
        bwd = row_tail2_bwd_plain if x.device.type == "cpu" else row_tail2_bwd_cuda
        grads = bwd(*saved, g.to(x.dtype).contiguous(), ctx.eps)
        return (*(d.to(p.dtype) for d, p in zip(grads, saved)), None)


def fused_row_tail2(x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b,
                    eps: float = 1e-5) -> torch.Tensor:
    """The two-Linear tail of LanePooling (reference lanercnn.py:497-505).

    x/res [N, W] in one dtype (W = 128 or 64 on the card); w1/w2 [W, W]
    (in, out), cast to x's dtype (their gradients flow back through the
    casts); GN affines [W] fp32. CPU tensors take the plain versions; CUDA tensors launch the
    kernels."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_tail: unsupported device {x.device}")
    return _RowTail2.apply(x.contiguous(), res.contiguous(), w1.to(x.dtype).contiguous(),
                           w2.to(x.dtype).contiguous(), g1w, g1b, g2w, g2b, g3w, g3b, eps)


def work(n: int, itemsize: int, c: int = C) -> dict:
    """The forward's bytes and operations at width c: x and res read and
    out written once, W and the GN vectors read; one [N, c] x [c, c]
    product."""
    return {"bytes": 3 * n * c * itemsize + c * c * itemsize + 4 * c * 4,
            "flops": 2 * n * c * c}


def work_bwd(n: int, itemsize: int, c: int = C) -> dict:
    """The backward's bytes and operations at width c: x, res and g read
    and dx, dres written once, W read and dW and the GN vectors written;
    three [N, c] x [c, c] products (z recomputed, d_h, dW)."""
    return {"bytes": 5 * n * c * itemsize + c * c * (itemsize + 4) + 8 * c * 4,
            "flops": 3 * 2 * n * c * c}


def work2(n: int, itemsize: int, c: int = C) -> dict:
    """K = 2 at width c: x and res read and out written once, both weights
    and the six GN vectors read; two [N, c] x [c, c] products."""
    return {"bytes": 3 * n * c * itemsize + 2 * c * c * itemsize + 6 * c * 4,
            "flops": 2 * 2 * n * c * c}


def work2_bwd(n: int, itemsize: int, c: int = C) -> dict:
    """K = 2 backward at width c: x, res and g read and dx, dres written
    once, both weights read and their gradients and the six GN vectors
    written; six [N, c] x [c, c] products (t1 and t2 recomputed, d_h2 and
    d_h1, dW2 and dW1)."""
    return {"bytes": 5 * n * c * itemsize + 2 * c * c * (itemsize + 4) + 12 * c * 4,
            "flops": 6 * 2 * n * c * c}
