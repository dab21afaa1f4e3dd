"""Window-pair fused edge MLP + destination scatter: the `win_edge` CUDA
kernels (csrc/win_edge.cu: forward, backward destination and source
passes) and their plain versions.

Per planned edge (u ← v):
    t1 = relu(Pd[u] + Ps[v] + bd);  t2 = relu(GN(t1 @ Wdo))
    s  = t2 @ K1 + Cs[v] + Qd[u];   e1 = relu(GN(s))
    out[u] += e1 @ Wout             (out starts as temp)

Counterpart of lanegcn_tpu/ops/pallas_win_edge.py `win_edge_mlp` with
has_dist2 and has_query (the Att configuration). The caller folds the
distance embedding's signs into Pd/Ps. The public op runs through a
`torch.autograd.Function` whose backward is the two
backward kernels on CUDA tensors and `win_edge_bwd_plain` on CPU tensors;
temp's cotangent is the output's, unchanged.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats, group_norm


def _edge_rows(plan: PairPlan, nd: int, ns: int):
    """(valid edge positions, global dst rows, global src rows)."""
    lu = plan.idx[:, 0].long()
    lv = plan.idx[:, 1].long()
    ch = torch.arange(lu.shape[0], device=lu.device) // plan.chunk
    u = plan.dwin.long()[ch] * plan.dst_stride + lu
    v = plan.swin.long()[ch] * plan.src_stride + lv
    ok = (lu >= 0) & (lu < plan.dst_stride) & (lv >= 0) & (lv < plan.src_stride)
    ok &= (u < nd) & (v < ns)
    sel = ok.nonzero().squeeze(1)
    return sel, u[sel], v[sel]


def win_edge_plain(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                   plan: PairPlan, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 products of dtype-valued
    operands, t1/t2/e1 rounded to the activation dtype, fp32 scatter into
    temp and one rounding."""
    dt = pd.dtype
    _, u, v = _edge_rows(plan, pd.shape[0], ps.shape[0])
    rnd = lambda x: x.to(dt).float()
    t1 = rnd(torch.relu(pd[u].float() + ps[v].float() + bd.float()))
    t2 = rnd(torch.relu(group_norm(t1 @ kdo.to(dt).float(), gdow, gdob, 1, eps)))
    s = t2 @ k1.to(dt).float() + cs[v].float() + qd[u].float()
    e1 = rnd(torch.relu(group_norm(s, gchw, gchb, 1, eps)))
    e2 = e1 @ kout.to(dt).float()
    out = temp.to(torch.float32, copy=True).index_add_(0, u, e2)
    return out.to(temp.dtype)


def win_edge_bwd_plain(pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                       plan: PairPlan, g, eps: float = 1e-5):
    """The backward kernels' arithmetic: recompute the chain per valid edge,
    then back through Wout, GN(ch), K1, GN(do), Wdo and the ReLUs, rounding
    d_e2, d_s, d_z and d_t1p to the activation dtype before their products
    and scatters. Returns (dPd, dQd, dPs, dCs) in pd's dtype (fp32 sums, one
    rounding; zero on rows no edge touches), then fp32 dbd, dWdo, dgdow,
    dgdob, dK1, dgchw, dgchb, dWout."""
    dt = pd.dtype
    nd, ns = pd.shape[0], ps.shape[0]
    _, u, v = _edge_rows(plan, nd, ns)
    rnd = lambda x: x.to(dt).float()
    w_do, w_1, w_out = (rnd(w) for w in (kdo, k1, kout))
    t1 = rnd(torch.relu(pd[u].float() + ps[v].float() + bd.float()))
    nrm_z, inv_z = gn_stats(t1 @ w_do, eps)
    t2 = rnd(torch.relu(nrm_z * gdow.float() + gdob.float()))
    nrm_s, inv_s = gn_stats(t2 @ w_1 + cs[v].float() + qd[u].float(), eps)
    e1 = rnd(torch.relu(nrm_s * gchw.float() + gchb.float()))
    d_e2 = rnd(g[u])
    d_gn_s = torch.where(e1 > 0, d_e2 @ w_out.t(), 0.0)
    d_s = rnd(gn_bwd(d_gn_s, nrm_s, inv_s, gchw))
    d_gn_z = torch.where(t2 > 0, d_s @ w_1.t(), 0.0)
    d_z = rnd(gn_bwd(d_gn_z, nrm_z, inv_z, gdow))
    d_t1p = torch.where(t1 > 0, d_z @ w_do.t(), 0.0)
    d_t1 = rnd(d_t1p)
    f32 = dict(dtype=torch.float32, device=pd.device)
    scatter = lambda rows, idx, x: torch.zeros(rows, x.shape[1], **f32).index_add_(0, idx, x).to(dt)
    return (scatter(nd, u, d_t1), scatter(nd, u, d_s), scatter(ns, v, d_t1), scatter(ns, v, d_s),
            d_t1p.sum(0), t1.t() @ d_z, (d_gn_z * nrm_z).sum(0), d_gn_z.sum(0),
            t2.t() @ d_s, (d_gn_s * nrm_s).sum(0), d_gn_s.sum(0), e1.t() @ d_e2)


def _check(pd, qd, ps, cs, temp, weights, vectors, plan: PairPlan):
    nd, c = pd.shape
    nc = plan.num_chunks
    if (c != 128 or qd.shape != pd.shape or temp.shape != pd.shape or cs.shape != ps.shape
            or ps.shape[1] != c
            or any(tuple(w.shape) != (c, c) for w in weights)
            or any(tuple(p.shape) != (c,) for p in vectors)
            or plan.idx.dim() != 2 or plan.idx.shape[0] != nc * plan.chunk
            or plan.idx.shape[1] < 2 or tuple(plan.meta.shape) != (6, nc)):
        raise ValueError(f"win_edge: bad shapes pd {pd.shape} ps {ps.shape} "
                         f"plan idx {plan.idx.shape} meta {plan.meta.shape}")
    if any(t.dtype != pd.dtype for t in (qd, ps, cs, temp)):
        raise TypeError("win_edge: pd, qd, ps, cs and temp must share one dtype")
    if plan.idx.dtype != torch.int32 or plan.meta.dtype != torch.int32:
        raise TypeError("win_edge: plan indices must be int32")


def _plan_args(plan: PairPlan, nd: int, ns: int):
    return (ctypes.c_int(plan.num_chunks), ctypes.c_int(plan.chunk),
            ctypes.c_int(plan.dst_stride), ctypes.c_int(plan.src_stride),
            ctypes.c_int(plan.idx.shape[1]), ctypes.c_int(nd), ctypes.c_int(ns))


def _fwd_cuda(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, plan, eps):
    _check(pd, qd, ps, cs, temp, (kdo, k1, kout), (bd, gdow, gdob, gchw, gchb), plan)
    nd, c = pd.shape
    dt = pd.dtype
    ws = [cuda.param(w, dt) for w in (kdo, k1, kout)]
    vs = [cuda.param(p) for p in (bd, gdow, gdob, gchw, gchb)]
    code = cuda.check_cuda("win_edge", pd, qd, ps, cs, temp, plan.idx, plan.meta, *ws, *vs)
    out = temp.clone()
    acc = out if dt == torch.float32 else torch.empty(nd, c, dtype=torch.float32,
                                                     device=pd.device)
    cuda.call(
        "win_edge", "win_edge_fwd",
        cuda.ptr(pd), cuda.ptr(qd), cuda.ptr(ps), cuda.ptr(cs), cuda.ptr(temp),
        cuda.ptr(vs[0]), cuda.ptr(ws[0]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[1]),
        cuda.ptr(vs[3]), cuda.ptr(vs[4]), cuda.ptr(ws[2]), cuda.ptr(plan.idx),
        cuda.ptr(plan.meta), cuda.ptr(acc), cuda.ptr(out), ctypes.c_int(int(acc is not out)),
        *_plan_args(plan, nd, ps.shape[0]), ctypes.c_float(eps), ctypes.c_int(code),
        cuda.stream(),
    )
    return out


# A source-pass block holds two fp32 [src_stride, 32] slices in shared memory.
MAX_SRC_STRIDE = 232448 // (2 * 32 * 4)
PART = 3 * 128 * 128 + 5 * 128  # dWdo, dK1, dWout, dbd, dgdow, dgdob, dgchw, dgchb


def win_edge_bwd_cuda(pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                      plan: PairPlan, g, eps: float = 1e-5):
    """The `win_edge_bwd_d` and `win_edge_bwd_s` kernels; the same outputs
    as `win_edge_bwd_plain`."""
    _check(pd, qd, ps, cs, g, (kdo, k1, kout), (bd, gdow, gdob, gchw, gchb), plan)
    if plan.src_stride > MAX_SRC_STRIDE:
        raise ValueError(f"win_edge: source windows of {plan.src_stride} rows exceed "
                         f"{MAX_SRC_STRIDE}")
    nd, c = pd.shape
    ns = ps.shape[0]
    dt = pd.dtype
    dev = pd.device
    ws = [cuda.param(w, dt) for w in (kdo, k1, kout)]
    vs = [cuda.param(p) for p in (bd, gdow, gdob, gchw, gchb)]
    code = cuda.check_cuda("win_edge", pd, qd, ps, cs, g, plan.idx, plan.meta, *ws, *vs)
    f32 = dict(dtype=torch.float32, device=dev)
    dpd, dqd = torch.zeros_like(pd), torch.zeros_like(qd)
    if dt == torch.float32:
        acc_pd, acc_qd = dpd, dqd
    else:
        acc_pd, acc_qd = torch.zeros(nd, c, **f32), torch.zeros(nd, c, **f32)
    slots = plan.num_chunks * plan.chunk
    ds_save = torch.empty(slots, c, dtype=dt, device=dev)
    dt1_save = torch.empty(slots, c, dtype=dt, device=dev)
    windows = -(-nd // plan.dst_stride)
    part = torch.zeros(windows * PART, **f32)
    grads = torch.empty(PART, **f32)
    pa = _plan_args(plan, nd, ns)
    cuda.call(
        "win_edge", "win_edge_bwd_d",
        cuda.ptr(pd), cuda.ptr(qd), cuda.ptr(ps), cuda.ptr(cs), cuda.ptr(g),
        cuda.ptr(vs[0]), cuda.ptr(ws[0]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[1]),
        cuda.ptr(vs[3]), cuda.ptr(vs[4]), cuda.ptr(ws[2]), cuda.ptr(plan.idx),
        cuda.ptr(plan.meta), cuda.ptr(acc_pd), cuda.ptr(acc_qd), cuda.ptr(dpd), cuda.ptr(dqd),
        ctypes.c_int(int(acc_pd is not dpd)), cuda.ptr(ds_save), cuda.ptr(dt1_save),
        cuda.ptr(part), cuda.ptr(grads), ctypes.c_int(windows), *pa, ctypes.c_float(eps),
        ctypes.c_int(code), cuda.stream(),
    )
    dps, dcs = torch.zeros_like(ps), torch.zeros_like(cs)
    cuda.call(
        "win_edge", "win_edge_bwd_s",
        cuda.ptr(ds_save), cuda.ptr(dt1_save), cuda.ptr(plan.idx), cuda.ptr(plan.meta),
        cuda.ptr(dps), cuda.ptr(dcs), *pa, ctypes.c_int(code), cuda.stream(),
    )
    mats = grads[: 3 * c * c].view(3, c, c)
    vecs = grads[3 * c * c:].view(5, c)
    return (dpd, dqd, dps, dcs, vecs[0], mats[0], vecs[1], vecs[2], mats[1], vecs[3], vecs[4],
            mats[2])


class _WinEdge(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `win_edge_bwd_plain` / `win_edge_bwd_cuda`; temp's cotangent
    is g unchanged; each other cotangent in its primal's dtype."""

    @staticmethod
    def forward(ctx, pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, plan, eps):
        args = (pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout)
        ctx.save_for_backward(*args)
        ctx.plan, ctx.eps = plan, eps
        if pd.device.type == "cpu":
            return win_edge_plain(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb,
                                  kout, plan, eps)
        return _fwd_cuda(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                         plan, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        pd = saved[0]
        bwd = win_edge_bwd_plain if pd.device.type == "cpu" else win_edge_bwd_cuda
        grads = bwd(*saved, ctx.plan, g.to(pd.dtype).contiguous(), ctx.eps)
        d = [x.to(p.dtype) for x, p in zip(grads, saved)]
        return (*d[:4], g, *d[4:], None, None)


def win_edge_mlp(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                 plan: PairPlan, eps: float = 1e-5) -> torch.Tensor:
    """temp + scatter(edge MLP over the window-pair plan).

    pd/qd/temp [Nd, 128], ps/cs [Ns, 128] in one activation dtype; bd and
    GN affines [128] fp32; kdo/k1/kout [128, 128] (in, out), cast to the
    activation dtype inside (their gradients come back in their own dtype).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Destination windows no chunk touches keep temp: the kernel updates a
    clone of temp.
    """
    if pd.device.type not in ("cpu", "cuda"):
        raise ValueError(f"win_edge: unsupported device {pd.device}")
    return _WinEdge.apply(*(t.contiguous() for t in (pd, qd, ps, cs, temp)), bd, kdo, gdow, gdob,
                          k1, gchw, gchb, kout, plan, eps)


def work(pd, ps, plan: PairPlan) -> dict:
    """Bytes moved and operations done at these inputs. The work depends on
    the plan's data: pd/qd are read at the distinct destination rows of
    valid edges and ps/cs at their distinct source rows; temp is read and
    the output written whole; the plan and the weights are read once; the
    three products run on valid edges only."""
    nd, c = pd.shape
    db = pd.element_size()
    sel, u, v = _edge_rows(plan, nd, ps.shape[0])
    dst_rows, src_rows = int(u.unique().numel()), int(v.unique().numel())
    return {
        "bytes": (2 * dst_rows + 2 * src_rows + 2 * nd) * c * db
        + plan.idx.numel() * 4 + plan.meta.numel() * 4 + 3 * c * c * db + 5 * c * 4,
        "flops": 3 * 2 * int(sel.numel()) * c * c,
        "edges": int(sel.numel()),
        "dst_rows": dst_rows,
        "src_rows": src_rows,
    }


def work_bwd(pd, ps, plan: PairPlan) -> dict:
    """The backward's bytes and operations at these inputs: Pd/Qd and g read
    at the distinct destination rows and Ps/Cs at the distinct source rows
    of valid edges, dPd/dQd/dPs/dCs written whole, the plan and weights read
    and the parameter gradients written; nine products per valid edge (three
    recomputed, three transposed, three weight gradients). `slot_bytes` is
    apart: the per-edge rnd(d_s) and rnd(d_t1p) that the destination pass
    writes and the source pass reads back, traffic of the two-pass design
    and not of the function."""
    nd, c = pd.shape
    ns = ps.shape[0]
    db = pd.element_size()
    sel, u, v = _edge_rows(plan, nd, ps.shape[0])
    e = int(sel.numel())
    dst_rows, src_rows = int(u.unique().numel()), int(v.unique().numel())
    return {
        "bytes": (3 * dst_rows + 2 * src_rows + 2 * nd + 2 * ns) * c * db
        + plan.idx.numel() * 4 + plan.meta.numel() * 4 + 3 * c * c * (db + 4) + 10 * c * 4,
        "flops": 9 * 2 * e * c * c,
        "edges": e,
        "slot_bytes": 4 * e * c * db,
    }
