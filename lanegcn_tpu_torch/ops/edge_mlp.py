"""The fused per-edge MLP over a flat edge list: the `edge_mlp` CUDA kernels
(csrc/edge_mlp.cu) and their plain versions.

Per row e of the list (padding rows included):
    t1 = relu(d[e] @ Wd + bd);  t2 = relu(GN(t1 @ Wdo))   [has_dist2]
    s  = t2 @ K1 + cg[e] (+ qg[e] with has_query);  e1 = relu(GN(s))
    out[e] = e1 @ Wout

Counterpart of lanegcn_tpu/ops/pallas_edge_mlp.py `fused_edge_mlp` in its
two configurations: Att's (has_dist2 and has_query, d [E, 2]) and
LanePooling's (neither; t2 = t1, d [E, 4]). The gathers before it and the
destination scatter after it stay outside. Each configuration runs
through a `torch.autograd.Function`: Att's backward is the `edge_mlp_bwd`
kernel on CUDA tensors and `edge_mlp_bwd_plain` on CPU tensors,
LanePooling's the `edge_mlp_pool_bwd` kernel and `edge_mlp_pool_bwd_plain`.
In bf16 both configurations multiply on the tensor cores (wgmma); fp32 runs
the CUDA-core kernels, the parity path. Both configurations' kernels take
rows W = 128 or 64 wide (Att's: A2A where n_actor = 64, and also 256
both ways, the double-width model, csrc/wide.cuh and csrc/wide_bwd.cuh;
LanePooling's: LaneRCNN at n_map = 64); the plain versions take any width.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats, group_norm


def part_size(c: int) -> int:
    """Att's fp32 backward partial at width c: dWdo, dK1, dWout, dbd, dgdow,
    dgdob, dgchw, dgchb, dWd (2 rows)."""
    return 3 * c * c + 7 * c


def edge_mlp_plain(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                   has_dist2: bool = True, has_query: bool = True,
                   eps: float = 1e-5) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch: d and the weights rounded to the
    activation dtype, fp32 products and statistics, t1/t2/e1 and the output
    rounded to the activation dtype. Without has_dist2, kdo/gdow/gdob are
    not read; without has_query, qg is not."""
    dt = cg.dtype
    rnd = lambda x: x.to(dt).float()
    t = rnd(torch.relu(rnd(d) @ rnd(kd) + bd.float()))
    if has_dist2:
        t = rnd(torch.relu(group_norm(t @ rnd(kdo), gdow, gdob, 1, eps)))
    s = t @ rnd(k1) + cg.float()
    if has_query:
        s = s + qg.float()
    e1 = rnd(torch.relu(group_norm(s, gchw, gchb, 1, eps)))
    return (e1 @ rnd(kout)).to(dt)


def edge_mlp_bwd_plain(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, g,
                       eps: float = 1e-5):
    """The backward kernel's arithmetic: recompute the chain, then back
    through Wout, GN(ch), K1, GN(do), Wdo, the ReLUs and Wd, rounding the
    cotangent, d_s, d_z and d_t1p to the activation dtype before their
    products. Returns (dd fp32 [E, 2], dqg, dcg in the activation dtype),
    then fp32 dWd, dbd, dWdo, dgdow, dgdob, dK1, dgchw, dgchb, dWout: one
    gradient per input, in the inputs' order."""
    dt = cg.dtype
    rnd = lambda x: x.to(dt).float()
    w_d, w_do, w_1, w_out = (rnd(w) for w in (kd, kdo, k1, kout))
    dr = rnd(d)
    t1 = rnd(torch.relu(dr @ w_d + bd.float()))
    nrm_z, inv_z = gn_stats(t1 @ w_do, eps)
    t2 = rnd(torch.relu(nrm_z * gdow.float() + gdob.float()))
    nrm_s, inv_s = gn_stats(t2 @ w_1 + cg.float() + qg.float(), eps)
    e1 = rnd(torch.relu(nrm_s * gchw.float() + gchb.float()))
    d_e2 = rnd(g)
    d_gn_s = torch.where(e1 > 0, d_e2 @ w_out.t(), 0.0)
    d_s = rnd(gn_bwd(d_gn_s, nrm_s, inv_s, gchw))
    d_gn_z = torch.where(t2 > 0, d_s @ w_1.t(), 0.0)
    d_z = rnd(gn_bwd(d_gn_z, nrm_z, inv_z, gdow))
    d_t1p = torch.where(t1 > 0, d_z @ w_do.t(), 0.0)
    d_t1 = rnd(d_t1p)
    return (d_t1 @ w_d.t(), d_s.to(dt), d_s.to(dt), dr.t() @ d_t1, d_t1p.sum(0), t1.t() @ d_z,
            (d_gn_z * nrm_z).sum(0), d_gn_z.sum(0), t2.t() @ d_s, (d_gn_s * nrm_s).sum(0),
            d_gn_s.sum(0), e1.t() @ d_e2)


def _check(d, qg, cg, kd, weights, vectors, name="edge_mlp"):
    """Shapes and dtypes Att's kernel `name` takes: qg/cg [E, W] with W one
    of its widths (`cuda.WIDTHS`: 64, 128 or 256 both ways), d [E, 2], kd
    [2, W], the weights [W, W], the vectors [W]."""
    e, c = cg.shape
    cuda.check_width(name, c)
    if (qg.shape != cg.shape or tuple(d.shape) != (e, 2) or tuple(kd.shape) != (2, c)
            or any(tuple(w.shape) != (c, c) for w in weights)
            or any(tuple(p.shape) != (c,) for p in vectors)):
        raise ValueError(f"edge_mlp: bad shapes d {d.shape} qg {qg.shape} cg {cg.shape} "
                         f"kd {kd.shape}")
    if qg.dtype != cg.dtype or d.dtype != torch.float32:
        raise TypeError("edge_mlp: qg and cg must share one dtype, d must be float32")


def _prep(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, *rows, name="edge_mlp"):
    """(d, qg, cg, *rows), weights, vectors, dtype code for Att's kernel
    `name`: the row tensors contiguous and 16-byte aligned (the bf16 kernels
    copy them by cp.async and store 16-byte rows)."""
    _check(d, qg, cg, kd, (kdo, k1, kout), (bd, gdow, gdob, gchw, gchb), name)
    dt = cg.dtype
    acts = [cuda.param(x, x.dtype) for x in (d, qg, cg, *rows)]
    ws = [cuda.param(w, dt) for w in (kd, kdo, k1, kout)]
    vs = [cuda.param(p) for p in (bd, gdow, gdob, gchw, gchb)]
    code = cuda.check_cuda("edge_mlp", *acts[1:], acts[0], *ws, *vs)
    return acts, ws, vs, code


def _fwd_cuda(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, eps):
    (d, qg, cg), ws, vs, code = _prep(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout)
    out = torch.empty_like(cg)
    cuda.call(
        "edge_mlp", "edge_mlp_fwd",
        cuda.ptr(d), cuda.ptr(qg), cuda.ptr(cg), cuda.ptr(ws[0]), cuda.ptr(vs[0]),
        cuda.ptr(ws[1]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[2]), cuda.ptr(vs[3]),
        cuda.ptr(vs[4]), cuda.ptr(ws[3]), cuda.ptr(out), ctypes.c_int(cg.shape[0]),
        ctypes.c_int(cg.shape[1]), ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return out


def edge_mlp_bwd_cuda(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, g,
                      eps: float = 1e-5):
    """The `edge_mlp_bwd` kernel; the same outputs as `edge_mlp_bwd_plain`.
    bf16 runs the chain pass, then the weight-gradient pass over its
    operands (`act`, [E, 4W] bf16), and sums each pass's partials in block
    (split) order; nothing is zeroed. fp32 adds into a zeroed [blocks,
    part_size(W)] workspace. At W = 256 both dtypes run the two passes
    (csrc/wide_bwd.cuh): `act` then holds E·4W values of the activation
    dtype and the chain's normalised rows, E·2W fp32, and the weight-
    gradient pass has a block per quadrant of each gradient."""
    if g.shape != cg.shape or g.dtype != cg.dtype:
        raise ValueError(f"edge_mlp: cotangent {g.shape} {g.dtype} for {cg.shape} {cg.dtype}")
    (d, qg, cg, g), ws, vs, code = _prep(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb,
                                         kout, g, name="edge_mlp_bwd")
    dev = cg.device
    e, c = cg.shape
    f32 = dict(dtype=torch.float32, device=dev)
    blocks = cuda.num_sms(dev)
    # The weight-gradient pass's splits: 3 blocks each at 128 and 64, 12 (a
    # quadrant of each gradient) at 256; about two blocks an SM either way.
    splits = max(1, blocks // 2) if c != 256 else max(1, blocks // 6)
    dd = torch.empty(d.shape, **f32)
    dqg, dcg = torch.empty_like(cg), torch.empty_like(cg)
    if c == 256:
        act = torch.empty(e * 4 * c * cg.element_size() + e * 2 * c * 4, dtype=torch.uint8,
                          device=dev)
        part = torch.empty(blocks * 7 * c + splits * 3 * c * c, **f32)
    elif cg.dtype == torch.bfloat16:
        act = torch.empty(e, 4 * c, dtype=cg.dtype, device=dev)
        part = torch.empty(blocks * 7 * c + splits * 3 * c * c, **f32)
    else:
        act, part = None, torch.zeros(blocks * part_size(c), **f32)
    grads = torch.empty(part_size(c), **f32)
    cuda.call(
        "edge_mlp", "edge_mlp_bwd",
        cuda.ptr(d), cuda.ptr(qg), cuda.ptr(cg), cuda.ptr(g), cuda.ptr(ws[0]), cuda.ptr(vs[0]),
        cuda.ptr(ws[1]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[2]), cuda.ptr(vs[3]),
        cuda.ptr(vs[4]), cuda.ptr(ws[3]), cuda.ptr(dd), cuda.ptr(dqg), cuda.ptr(dcg),
        cuda.ptr(act), cuda.ptr(part), cuda.ptr(grads), ctypes.c_int(e), ctypes.c_int(c),
        ctypes.c_int(blocks), ctypes.c_int(splits), ctypes.c_float(eps), ctypes.c_int(code),
        cuda.stream(),
    )
    mats = grads[: 3 * c * c].view(3, c, c)
    vecs = grads[3 * c * c:].view(7, c)
    return (dd, dqg, dcg, vecs[5:7], vecs[0], mats[0], vecs[1], vecs[2], mats[1], vecs[3],
            vecs[4], mats[2])


class _EdgeMlp(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `edge_mlp_bwd_plain` / `edge_mlp_bwd_cuda`; each gradient in
    its input's dtype."""

    @staticmethod
    def forward(ctx, d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, eps):
        args = (d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout)
        ctx.save_for_backward(*args)
        ctx.eps = eps
        if cg.device.type == "cpu":
            return edge_mlp_plain(*args, True, True, eps)
        return _fwd_cuda(*args, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        cg = saved[2]
        bwd = edge_mlp_bwd_plain if cg.device.type == "cpu" else edge_mlp_bwd_cuda
        grads = bwd(*saved, g.to(cg.dtype).contiguous(), ctx.eps)
        return (*(x.to(p.dtype) for x, p in zip(grads, saved)), None)


def edge_mlp_pool_bwd_plain(d, cg, kd, bd, k1, gchw, gchb, kout, g, eps: float = 1e-5):
    """LanePooling's backward kernel's arithmetic (no dist_out stage, so
    d_t1 = d_t2): recompute the chain, then back through Wout, GN(ch), K1,
    the ReLU and Wd, rounding the cotangent, d_s and d_t1p to the activation
    dtype before their products. Returns dd fp32 [E, din] and dcg in the
    activation dtype, then fp32 dWd, dbd, dK1, dgchw, dgchb, dWout: one
    gradient per input, in the inputs' order."""
    dt = cg.dtype
    rnd = lambda x: x.to(dt).float()
    w_d, w_1, w_out = (rnd(w) for w in (kd, k1, kout))
    dr = rnd(d)
    t1 = rnd(torch.relu(dr @ w_d + bd.float()))
    nrm_s, inv_s = gn_stats(t1 @ w_1 + cg.float(), eps)
    e1 = rnd(torch.relu(nrm_s * gchw.float() + gchb.float()))
    d_e2 = rnd(g)
    d_gn_s = torch.where(e1 > 0, d_e2 @ w_out.t(), 0.0)
    d_s = rnd(gn_bwd(d_gn_s, nrm_s, inv_s, gchw))
    d_t1p = torch.where(t1 > 0, d_s @ w_1.t(), 0.0)
    d_t1 = rnd(d_t1p)
    return (d_t1 @ w_d.t(), d_s.to(dt), dr.t() @ d_t1, d_t1p.sum(0), t1.t() @ d_s,
            (d_gn_s * nrm_s).sum(0), d_gn_s.sum(0), e1.t() @ d_e2)


def pool_part_size(c: int, din: int) -> int:
    """LanePooling's backward partial at width c: dK1, dWout, dbd, dgchw,
    dgchb, dWd (din rows)."""
    return 2 * c * c + (3 + din) * c


def _pool_prep(d, cg, kd, bd, k1, gchw, gchb, kout, *rows, name="edge_mlp_pool"):
    """(d, cg, *rows), weights, vectors, dtype code for the pool kernels
    (`name` in the messages): the row tensors contiguous and 16-byte
    aligned (the bf16 kernels copy them by cp.async)."""
    e, c = cg.shape
    din = d.shape[1] if d.dim() == 2 else 0
    cuda.check_width(name, c)
    if (tuple(d.shape) != (e, din) or din not in (2, 4)
            or tuple(kd.shape) != (din, c) or tuple(k1.shape) != (c, c)
            or tuple(kout.shape) != (c, c)
            or any(tuple(p.shape) != (c,) for p in (bd, gchw, gchb))):
        raise ValueError(f"{name}: bad shapes d {d.shape} cg {cg.shape} kd {kd.shape} "
                         f"(rows {c} wide)")
    if d.dtype != torch.float32:
        raise TypeError(f"{name}: d must be float32")
    dt = cg.dtype
    acts = [cuda.param(x, x.dtype) for x in (d, cg, *rows)]
    ws = [cuda.param(w, dt) for w in (kd, k1, kout)]
    vs = [cuda.param(p) for p in (bd, gchw, gchb)]
    code = cuda.check_cuda("edge_mlp", *acts[1:], acts[0], *ws, *vs)
    return acts, ws, vs, code


def _pool_fwd_cuda(d, cg, kd, bd, k1, gchw, gchb, kout, eps):
    (d, cg), ws, vs, code = _pool_prep(d, cg, kd, bd, k1, gchw, gchb, kout)
    out = torch.empty_like(cg)
    cuda.call(
        "edge_mlp", "edge_mlp_pool_fwd",
        cuda.ptr(d), cuda.ptr(cg), cuda.ptr(ws[0]), cuda.ptr(vs[0]), cuda.ptr(ws[1]),
        cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[2]), cuda.ptr(out), ctypes.c_int(cg.shape[0]),
        ctypes.c_int(cg.shape[1]), ctypes.c_int(d.shape[1]), ctypes.c_float(eps),
        ctypes.c_int(code), cuda.stream(),
    )
    return out


def edge_mlp_pool_bwd_cuda(d, cg, kd, bd, k1, gchw, gchb, kout, g, eps: float = 1e-5,
                           need_dd: bool = True):
    """The `edge_mlp_pool_bwd` kernel; the same outputs as
    `edge_mlp_pool_bwd_plain`, except dd is None when not `need_dd` (the
    kernel then skips it)."""
    if g.shape != cg.shape or g.dtype != cg.dtype:
        raise ValueError(f"edge_mlp: cotangent {g.shape} {g.dtype} for {cg.shape} {cg.dtype}")
    (d, cg, g), ws, vs, code = _pool_prep(d, cg, kd, bd, k1, gchw, gchb, kout, g,
                                          name="edge_mlp_pool_bwd")
    dev = cg.device
    e, din = d.shape
    c = cg.shape[1]
    blocks = cuda.num_sms(dev)
    dd = torch.empty(d.shape, dtype=torch.float32, device=dev) if need_dd else None
    dcg = torch.empty_like(cg)
    part = torch.empty(blocks * pool_part_size(c, din), dtype=torch.float32, device=dev)
    grads = torch.empty(pool_part_size(c, din), dtype=torch.float32, device=dev)
    cuda.call(
        "edge_mlp", "edge_mlp_pool_bwd",
        cuda.ptr(d), cuda.ptr(cg), cuda.ptr(g), cuda.ptr(ws[0]), cuda.ptr(vs[0]),
        cuda.ptr(ws[1]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[2]), cuda.ptr(dd),
        cuda.ptr(dcg), cuda.ptr(part), cuda.ptr(grads), ctypes.c_int(e), ctypes.c_int(c),
        ctypes.c_int(din), ctypes.c_int(blocks), ctypes.c_float(eps), ctypes.c_int(code),
        cuda.stream(),
    )
    mats = grads[:2 * c * c].view(2, c, c)
    vecs = grads[2 * c * c:].view(3 + din, c)
    return dd, dcg, vecs[3:], vecs[0], mats[0], vecs[1], vecs[2], mats[1]


class _EdgeMlpPool(torch.autograd.Function):
    """LanePooling's configuration, as `_EdgeMlp`: the plain versions on CPU
    tensors, the kernels on CUDA tensors; each gradient in its input's
    dtype. The kernel skips dd when d needs no gradient (in the model d is
    the pack's poses)."""

    @staticmethod
    def forward(ctx, d, cg, kd, bd, k1, gchw, gchb, kout, eps):
        args = (d, cg, kd, bd, k1, gchw, gchb, kout)
        if cg.device.type == "cpu":
            out = edge_mlp_plain(d, None, cg, kd, bd, None, None, None, k1, gchw, gchb, kout,
                                 False, False, eps)
        else:
            out = _pool_fwd_cuda(*args, eps)
        ctx.save_for_backward(*args)  # after the launch, as _RowTail2
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        cg = saved[1]
        g = g.to(cg.dtype).contiguous()
        if cg.device.type == "cpu":
            grads = edge_mlp_pool_bwd_plain(*saved, g, ctx.eps)
        else:
            grads = edge_mlp_pool_bwd_cuda(*saved, g, ctx.eps, ctx.needs_input_grad[0])
        return (*(None if x is None else x.to(p.dtype) for x, p in zip(grads, saved)), None)


def fused_edge_mlp(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                   has_dist2: bool = True, has_query: bool = True,
                   eps: float = 1e-5) -> torch.Tensor:
    """The per-edge chain; returns e2 [E, W] for the caller's masked
    destination scatter.

    Att (has_dist2, has_query): d [E, 2] fp32 (the edge's centre offset);
    qg/cg [E, W] in one activation dtype (the gathered query and context
    projections; W = 128, 64 or 256 on the card, 256 without a gradient);
    kd [2, W], kdo/k1/kout [W, W] (in, out), cast to the activation dtype
    inside; bd and the GN affines [W] fp32.
    LanePooling (neither flag): qg, kdo, gdow and gdob None; d [E, 4] fp32
    (the relative pose), kd [4, W], cg [E, W] (W = 128 or 64 on the card).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if cg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"edge_mlp: unsupported device {cg.device}")
    if has_dist2 and has_query:
        return _EdgeMlp.apply(d.contiguous(), qg.contiguous(), cg.contiguous(), kd, bd, kdo,
                              gdow, gdob, k1, gchw, gchb, kout, eps)
    if has_dist2 or has_query:
        raise NotImplementedError("edge_mlp: only Att's and LanePooling's configurations")
    return _EdgeMlpPool.apply(d.contiguous(), cg.contiguous(), kd, bd, k1, gchw, gchb, kout, eps)


def _live_rows(*rows) -> int:
    """Rows with a non-zero entry in any of `rows`, plus one if any row is all
    zero: all-zero rows (the padding) share one output row."""
    live = torch.zeros(rows[0].shape[0], dtype=torch.bool, device=rows[0].device)
    for x in rows:
        live |= (x != 0).any(1)
    n_live = int(live.sum())
    return n_live + int(n_live < live.numel())


def work(d, qg, cg, has_dist2: bool = True) -> dict:
    """Bytes moved and operations done at these inputs (rows W wide, W =
    cg's width): d, cg (and qg, where given) read and the output written
    whole, the weights read once; the chain's products (d @ Wd and three
    [W x W], two without has_dist2)
    run once per row with a non-zero input and once for all the all-zero
    (padding) rows together."""
    e, c = cg.shape
    din = d.shape[1]
    db = cg.element_size()
    rows = _live_rows(*(x for x in (d, qg, cg) if x is not None))
    mats = 3 if has_dist2 else 2
    acts = 2 + (qg is not None)
    return {
        "bytes": e * (din * 4 + acts * c * db) + (mats * c * c + din * c) * db
        + (2 * mats - 1) * c * 4,
        "flops": 2 * rows * (din * c + mats * c * c),
        "rows": e,
        "live_rows": rows,
    }


def work_bwd(d, qg, cg, g) -> dict:
    """The backward's bytes and operations at these inputs (rows W wide): d,
    qg, cg and g read and dd, dqg, dcg written whole, the weights read and
    their gradients written; nine [W x W] products (three recomputed, three
    transposed, three weight gradients) and the Wd ones on the rows whose
    cotangent is non-zero (a zero cotangent contributes nothing)."""
    e, c = cg.shape
    db = cg.element_size()
    rows = int((g != 0).any(1).sum())
    return {
        "bytes": e * (2 * 4 * 2 + 5 * c * db) + (3 * c * c + 2 * c) * (db + 4) + 10 * c * 4,
        "flops": 2 * rows * (9 * c * c + 6 * c),
        "rows": e,
        "live_rows": rows,
    }


def work_pool_bwd(d, cg, g) -> dict:
    """LanePooling's backward at these inputs, dd included (the model skips
    it, d being pack data; `chip_smoke.py` asks for it to check it): d, cg
    and g read and dd and dcg written whole, the weights read and their
    gradients written; per row whose cotangent is non-zero five [W x W]
    products (K1 recomputed, d_e1, d_t1, dK1, dWout) and three with Wd (t1
    recomputed, dWd, dd)."""
    e, c = cg.shape
    din = d.shape[1]
    db = cg.element_size()
    rows = int((g != 0).any(1).sum())
    return {
        "bytes": e * (2 * din * 4 + 3 * c * db) + (2 * c * c + din * c) * (db + 4) + 6 * c * 4,
        "flops": 2 * rows * (5 * c * c + 3 * din * c),
        "rows": e,
        "live_rows": rows,
    }
