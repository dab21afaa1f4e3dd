"""Window-pair fused edge MLP + destination scatter: the `win_edge` CUDA
kernels (csrc/win_edge.cu: the forward and the backward) and their plain
versions.

Per planned edge (u ← v):
    t1 = relu(Pd[u] + Ps[v] + bd);  t2 = relu(GN(t1 @ Wdo))
    s  = t2 @ K1 + Cs[v] + Qd[u];   e1 = relu(GN(s))
    out[u] += e1 @ Wout             (out starts as temp)

Counterpart of lanegcn_tpu/ops/pallas_win_edge.py `win_edge_mlp` with
has_dist2 and has_query (the Att configuration). The caller folds the
distance embedding's signs into Pd/Ps. The public op runs through a
`torch.autograd.Function` whose backward is the `win_edge_bwd` kernel on
CUDA tensors and `win_edge_bwd_plain` on CPU tensors; temp's cotangent is
the output's, unchanged.

The forward takes the plan as the packer lays it out (no preparation: a
serving step makes none): the chain per plan slot, then each destination
row's edges added in slot order. The backward walks the plan's valid edges
as `prepare_pair` lists them (once per plan and step: a fusion stage's two
Att layers share it): in destination order (a stable sort of the slots by
destination row), each with its position in source order. Both the kernel
and the plain version sum dPd/dQd over the destination order and dPs/dCs
over the source order, so a row's edges always add up in one fixed order.

The kernels, forward and backward, take rows W = 128 or 64 wide
(`cuda.WIDTHS`: Att at n_map = n_actor = 128, and the half-width model at 64).
The plain versions take any width.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats, group_norm
from lanegcn_tpu_torch.ops.scenario_agg import _arange
from lanegcn_tpu_torch.ops.segment_sum import segment_sum_plain


class PairPrep(NamedTuple):
    """A pair plan's valid edges as the backward walks them, over its S =
    NC*chunk slots; E valid edges take entries [0, E):

    eu, ev  [S] int32 destination / source global rows of the edges in
            destination order (stable: slot order within a row); nd / ns
            past E
    spos    [S] int32 each destination-ordered edge's position in source
            order (a stable sort of ev: destination order within a source
            row)
    dseg    [S] int64 eu as the segment sum's keys (nd past E)
    sseg    [S] int64 the source rows in source order (ns past E)
    count   [1] int32 E, on the plan's device
    nd, ns  the destination and source row counts it was made for
    """

    eu: torch.Tensor
    ev: torch.Tensor
    spos: torch.Tensor
    dseg: torch.Tensor
    sseg: torch.Tensor
    count: torch.Tensor
    nd: int
    ns: int


def _slot_rows(plan: PairPlan, nd: int, ns: int):
    """Per plan slot: (valid, global dst row, global src row). A slot is valid
    when its window-local rows lie inside their windows and its global rows
    below nd / ns; the rows are read only where valid."""
    lu, lv = plan.idx[:, 0].long(), plan.idx[:, 1].long()
    ch = _arange(lu.shape[0], lu.device) // plan.chunk
    u = plan.dwin.long()[ch] * plan.dst_stride + lu
    v = plan.swin.long()[ch] * plan.src_stride + lv
    ok = (lu >= 0) & (lu < plan.dst_stride) & (lv >= 0) & (lv < plan.src_stride)
    return ok & (u < nd) & (v < ns), u, v


def prepare_pair(plan: PairPlan, nd: int, ns: int) -> PairPrep:
    """The plan's valid slots in destination and source order. Sorts and
    scatters on the plan's device: no host sync."""
    ok, u, v = _slot_rows(plan, nd, ns)
    slots, dev = ok.shape[0], ok.device
    dseg, dperm = torch.sort(torch.where(ok, u, nd), stable=True)
    ev = torch.where(ok, v, ns)[dperm]
    sseg, sperm = torch.sort(ev, stable=True)
    spos = torch.empty_like(sperm).scatter_(0, sperm, _arange(slots, dev))
    count = ok.sum(dtype=torch.int32).reshape(1)
    i32 = lambda x: x.to(torch.int32)
    return PairPrep(i32(dseg), i32(ev), i32(spos), dseg, sseg, count, nd, ns)


def _prep_for(plan: PairPlan, nd: int, ns: int, prep):
    if prep is None:
        return prepare_pair(plan, nd, ns)
    if (prep.nd, prep.ns) != (nd, ns) or prep.eu.shape[0] != plan.idx.shape[0]:
        raise ValueError(f"win_edge: the plan was prepared for {prep.nd} x {prep.ns} rows and "
                         f"{prep.eu.shape[0]} slots, not {nd} x {ns} and {plan.idx.shape[0]}")
    return prep


def _edge_rows(plan: PairPlan, nd: int, ns: int):
    """(E, the valid edges' global dst rows, their src rows) in destination
    order (reads E back to the host)."""
    prep = prepare_pair(plan, nd, ns)
    e = int(prep.count)
    return e, prep.eu[:e].long(), prep.ev[:e].long()


def _pad(x):
    """x with one zero row appended: the row that past-E entries gather."""
    return F.pad(x, (0, 0, 0, 1))


def win_edge_plain(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                   plan: PairPlan, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: fp32 products of dtype-valued
    operands, t1/t2/e1 rounded to the activation dtype, fp32 sum into temp
    (each row's edges in slot order) and one rounding. Runs over every plan
    slot in slot order, as the kernel does; a padding slot gathers a zero
    row and adds into a dropped row (no compaction, no sort, no host
    sync)."""
    dt = pd.dtype
    nd, ns = pd.shape[0], ps.shape[0]
    ok, u, v = _slot_rows(plan, nd, ns)
    u, v = torch.where(ok, u, nd), torch.where(ok, v, ns)
    rnd = lambda x: x.to(dt).float()
    t1 = rnd(torch.relu(_pad(pd)[u].float() + _pad(ps)[v].float() + bd.float()))
    t2 = rnd(torch.relu(group_norm(t1 @ kdo.to(dt).float(), gdow, gdob, 1, eps)))
    s = t2 @ k1.to(dt).float() + _pad(cs)[v].float() + _pad(qd)[u].float()
    e1 = rnd(torch.relu(group_norm(s, gchw, gchb, 1, eps)))
    e2 = e1 @ kout.to(dt).float()
    out = _pad(temp.float()).index_add_(0, u, e2)
    return out[:nd].to(temp.dtype)


def win_edge_bwd_plain(pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                       plan: PairPlan, g, eps: float = 1e-5, prep=None):
    """The backward kernel's arithmetic: recompute the chain per edge, then
    back through Wout, GN(ch), K1, GN(do), Wdo and the ReLUs, rounding
    d_e2, d_s, d_z and d_t1p to the activation dtype before their products
    and scatters. dPd/dQd are segment sums over the destination order and
    dPs/dCs over the source order (`prepare_pair`), in fp32 with one
    rounding (zero on rows no edge touches). Runs over every plan slot: the
    slots past the valid edges take a zero cotangent row, which zeroes every
    product and sum they enter. Returns (dPd, dQd, dPs, dCs) in pd's dtype,
    then fp32 dbd, dWdo, dgdow, dgdob, dK1, dgchw, dgchb, dWout."""
    dt = pd.dtype
    (nd, c), ns = pd.shape, ps.shape[0]
    prep = _prep_for(plan, nd, ns, prep)
    u, v = prep.eu.long(), prep.ev.long()
    rnd = lambda x: x.to(dt).float()
    w_do, w_1, w_out = (rnd(w) for w in (kdo, k1, kout))
    t1 = rnd(torch.relu(_pad(pd)[u].float() + _pad(ps)[v].float() + bd.float()))
    nrm_z, inv_z = gn_stats(t1 @ w_do, eps)
    t2 = rnd(torch.relu(nrm_z * gdow.float() + gdob.float()))
    nrm_s, inv_s = gn_stats(t2 @ w_1 + _pad(cs)[v].float() + _pad(qd)[u].float(), eps)
    e1 = rnd(torch.relu(nrm_s * gchw.float() + gchb.float()))
    d_e2 = rnd(_pad(g)[u])
    d_gn_s = torch.where(e1 > 0, d_e2 @ w_out.t(), 0.0)
    d_s = rnd(gn_bwd(d_gn_s, nrm_s, inv_s, gchw))
    d_gn_z = torch.where(t2 > 0, d_s @ w_1.t(), 0.0)
    d_z = rnd(gn_bwd(d_gn_z, nrm_z, inv_z, gdow))
    d_t1p = torch.where(t1 > 0, d_z @ w_do.t(), 0.0)
    rows = torch.cat([d_t1p, d_s], 1).to(dt)  # rnd(d_t1p) | rnd(d_s) per edge
    by_src = torch.empty_like(rows).index_copy_(0, prep.spos.long(), rows)
    d_dst = segment_sum_plain(rows, prep.dseg, nd)
    d_src = segment_sum_plain(by_src, prep.sseg, ns)
    return (d_dst[:, :c], d_dst[:, c:], d_src[:, :c], d_src[:, c:],
            d_t1p.sum(0), t1.t() @ d_z, (d_gn_z * nrm_z).sum(0), d_gn_z.sum(0),
            t2.t() @ d_s, (d_gn_s * nrm_s).sum(0), d_gn_s.sum(0), e1.t() @ d_e2)


def _check(pd, qd, ps, cs, temp, weights, vectors, plan: PairPlan, name="win_edge"):
    """Shapes and dtypes kernel `name` takes: pd/qd/temp [Nd, W] and ps/cs
    [Ns, W] with W in `cuda.WIDTHS` (64 or 128), the weights [W, W], the vectors
    [W], a pair plan."""
    nd, c = pd.shape
    nc = plan.num_chunks
    cuda.check_width(name, c)
    if (qd.shape != pd.shape or temp.shape != pd.shape or cs.shape != ps.shape
            or ps.shape[1] != c
            or any(tuple(w.shape) != (c, c) for w in weights)
            or any(tuple(p.shape) != (c,) for p in vectors)
            or plan.idx.dim() != 2 or plan.idx.shape[0] != nc * plan.chunk
            or plan.idx.shape[1] < 2 or tuple(plan.meta.shape) != (6, nc)):
        raise ValueError(f"{name}: bad shapes pd {pd.shape} ps {ps.shape} "
                         f"plan idx {plan.idx.shape} meta {plan.meta.shape}")
    if any(t.dtype != pd.dtype for t in (qd, ps, cs, temp)):
        raise TypeError(f"{name}: pd, qd, ps, cs and temp must share one dtype")
    if plan.idx.dtype != torch.int32 or plan.meta.dtype != torch.int32:
        raise TypeError(f"{name}: plan indices must be int32")


def _plan_args(plan: PairPlan, nd: int, ns: int):
    return (ctypes.c_int(plan.num_chunks), ctypes.c_int(plan.chunk),
            ctypes.c_int(plan.dst_stride), ctypes.c_int(plan.src_stride),
            ctypes.c_int(plan.idx.shape[1]), ctypes.c_int(nd), ctypes.c_int(ns))


def _fwd_cuda(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, plan, eps):
    _check(pd, qd, ps, cs, temp, (kdo, k1, kout), (bd, gdow, gdob, gchw, gchb), plan)
    nd, c = pd.shape
    dt, dev = pd.dtype, pd.device
    ws = [cuda.param(w, dt) for w in (kdo, k1, kout)]
    vs = [cuda.param(p) for p in (bd, gdow, gdob, gchw, gchb)]
    # The kernel copies rows by 16-byte loads.
    pd, qd, ps, cs, temp = (cuda.param(t, dt) for t in (pd, qd, ps, cs, temp))
    code = cuda.check_cuda("win_edge", pd, qd, ps, cs, temp, plan.idx, plan.meta, *ws, *vs)
    # Each edge's fp32 e2 row at its plan slot, between the chain and the sum.
    e2_rows = torch.empty(plan.idx.shape[0], c, dtype=torch.float32, device=dev)
    out = torch.empty_like(temp)
    cuda.call(
        "win_edge", "win_edge_fwd",
        cuda.ptr(pd), cuda.ptr(qd), cuda.ptr(ps), cuda.ptr(cs), cuda.ptr(temp),
        cuda.ptr(vs[0]), cuda.ptr(ws[0]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[1]),
        cuda.ptr(vs[3]), cuda.ptr(vs[4]), cuda.ptr(ws[2]), cuda.ptr(plan.idx),
        cuda.ptr(plan.meta), cuda.ptr(e2_rows), cuda.ptr(out), *_plan_args(plan, nd, ps.shape[0]),
        ctypes.c_int(c), ctypes.c_int(cuda.num_sms(dev)), ctypes.c_float(eps), ctypes.c_int(code),
        cuda.stream(),
    )
    return out


def part_size(c: int) -> int:
    """The gradients at width c: dWdo, dK1, dWout, dbd, dgdow, dgdob, dgchw,
    dgchb (also the fp32 pass's partial per block)."""
    return 3 * c * c + 5 * c


def win_edge_bwd_cuda(pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                      plan: PairPlan, g, eps: float = 1e-5, prep=None):
    """The `win_edge_bwd` kernel; the same outputs as `win_edge_bwd_plain`
    (dPd/dQd and dPs/dCs as the two halves of one [rows, 2W] tensor each).
    `prep`: the plan's `prepare_pair`, made here when None."""
    _check(pd, qd, ps, cs, g, (kdo, k1, kout), (bd, gdow, gdob, gchw, gchb), plan,
           "win_edge_bwd")
    nd, c = pd.shape
    ns = ps.shape[0]
    dt, dev = pd.dtype, pd.device
    prep = _prep_for(plan, nd, ns, prep)
    ws = [cuda.param(w, dt) for w in (kdo, k1, kout)]
    vs = [cuda.param(p) for p in (bd, gdow, gdob, gchw, gchb)]
    # The kernel copies rows by 16-byte loads.
    pd, qd, ps, cs, g = (cuda.param(t, dt) for t in (pd, qd, ps, cs, g))
    code = cuda.check_cuda("win_edge", pd, qd, ps, cs, g, *ws, *vs, *prep[:6])
    slots = plan.idx.shape[0]
    blocks = cuda.num_sms(dev)
    splits = max(1, blocks // 2)
    f32 = dict(dtype=torch.float32, device=dev)
    # Per edge slot, in destination and in source order: rnd(d_t1p) | rnd(d_s);
    # in bf16 also t1 | t2 | e1 | rnd(d_z), the weight-gradient pass's operands.
    rows = torch.empty(2, slots, 2 * c, dtype=dt, device=dev)
    tc = dt == torch.bfloat16
    act = torch.empty(slots, 4 * c, dtype=dt, device=dev) if tc else None
    part = torch.empty(blocks * 5 * c + splits * 3 * c * c if tc else blocks * part_size(c),
                       **f32)
    grads = torch.empty(part_size(c), **f32)
    out_d = torch.empty(nd, 2 * c, dtype=dt, device=dev)
    out_s = torch.empty(ns, 2 * c, dtype=dt, device=dev)
    cuda.call(
        "win_edge", "win_edge_bwd",
        cuda.ptr(pd), cuda.ptr(qd), cuda.ptr(ps), cuda.ptr(cs), cuda.ptr(g),
        cuda.ptr(vs[0]), cuda.ptr(ws[0]), cuda.ptr(vs[1]), cuda.ptr(vs[2]), cuda.ptr(ws[1]),
        cuda.ptr(vs[3]), cuda.ptr(vs[4]), cuda.ptr(ws[2]), cuda.ptr(prep.eu), cuda.ptr(prep.ev),
        cuda.ptr(prep.spos), cuda.ptr(prep.dseg), cuda.ptr(prep.sseg), cuda.ptr(prep.count),
        cuda.ptr(rows), cuda.ptr(act), cuda.ptr(part), cuda.ptr(grads), cuda.ptr(out_d),
        cuda.ptr(out_s), ctypes.c_longlong(slots), ctypes.c_int(nd), ctypes.c_int(ns),
        ctypes.c_int(c), ctypes.c_int(blocks), ctypes.c_int(splits), ctypes.c_float(eps),
        ctypes.c_int(code),
        cuda.stream(),
    )
    mats = grads[: 3 * c * c].view(3, c, c)
    vecs = grads[3 * c * c:].view(5, c)
    return (out_d[:, :c], out_d[:, c:], out_s[:, :c], out_s[:, c:], vecs[0], mats[0], vecs[1],
            vecs[2], mats[1], vecs[3], vecs[4], mats[2])


class _WinEdge(torch.autograd.Function):
    """Forward: the plain version on CPU tensors, the kernel on CUDA tensors.
    Backward: `win_edge_bwd_plain` / `win_edge_bwd_cuda` on the plan's
    `prepare_pair` (the caller's, else made in the backward); temp's
    cotangent is g unchanged; each other cotangent in its primal's dtype."""

    @staticmethod
    def forward(ctx, pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, plan, eps,
                prep):
        args = (pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout)
        ctx.save_for_backward(*args)
        ctx.plan, ctx.eps, ctx.prep = plan, eps, prep
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
        grads = bwd(*saved, ctx.plan, g.to(pd.dtype).contiguous(), ctx.eps, ctx.prep)
        d = [x.to(p.dtype) for x, p in zip(grads, saved)]
        return (*d[:4], g, *d[4:], None, None, None)


def win_edge_mlp(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                 plan: PairPlan, eps: float = 1e-5, prep: PairPrep | None = None) -> torch.Tensor:
    """temp + scatter(edge MLP over the window-pair plan).

    pd/qd/temp [Nd, W], ps/cs [Ns, W] in one activation dtype (W = 128 or
    64 on the card, both ways); bd and GN affines [W]
    fp32; kdo/k1/kout [W, W] (in, out), cast to the activation dtype inside
    (their gradients come back in their own dtype).
    prep: the plan's `prepare_pair` for these row counts, which the
    backward walks (a fusion stage makes it once for its Att layers; None:
    the backward makes it). CPU tensors take the plain version; CUDA tensors
    launch the kernel. Rows no edge reaches keep temp.
    """
    if pd.device.type not in ("cpu", "cuda"):
        raise ValueError(f"win_edge: unsupported device {pd.device}")
    return _WinEdge.apply(*(t.contiguous() for t in (pd, qd, ps, cs, temp)), bd, kdo, gdow, gdob,
                          k1, gchw, gchb, kout, plan, eps, prep)


def work(pd, ps, plan: PairPlan) -> dict:
    """Bytes moved and operations done at these inputs. The work depends on
    the plan's data: pd/qd are read at the distinct destination rows of
    valid edges and ps/cs at their distinct source rows; temp is read and
    the output written whole (W wide); the plan and the [W, W] weights are
    read once; the three products (3·2·W² operations an edge) run on valid
    edges only. `slot_bytes` is apart: the fp32 e2 rows the chain pass
    writes and the sum pass reads back, traffic of the kernel's design and
    not of the function."""
    nd, c = pd.shape
    db = pd.element_size()
    e, u, v = _edge_rows(plan, nd, ps.shape[0])
    dst_rows, src_rows = int(u.unique().numel()), int(v.unique().numel())
    return {
        "bytes": (2 * dst_rows + 2 * src_rows + 2 * nd) * c * db
        + plan.idx.numel() * 4 + plan.meta.numel() * 4 + 3 * c * c * db + 5 * c * 4,
        "flops": 3 * 2 * e * c * c,
        "edges": e,
        "dst_rows": dst_rows,
        "src_rows": src_rows,
        "slot_bytes": 2 * e * c * 4,
    }


def work_bwd(pd, ps, plan: PairPlan) -> dict:
    """The backward's bytes and operations at these inputs: Pd/Qd and g read
    at the distinct destination rows and Ps/Cs at the distinct source rows
    of valid edges, dPd/dQd/dPs/dCs written whole, the plan and weights read
    and the parameter gradients written; nine products per valid edge (three
    recomputed, three transposed, three weight gradients). `slot_bytes` is
    apart: the per-edge rows the bf16 kernel writes and reads back between
    its passes (rnd(d_t1p) | rnd(d_s) in both orders, t1 | t2 | e1 | rnd(d_z)),
    traffic of its design and not of the function."""
    nd, c = pd.shape
    ns = ps.shape[0]
    db = pd.element_size()
    e, u, v = _edge_rows(plan, nd, ps.shape[0])
    dst_rows, src_rows = int(u.unique().numel()), int(v.unique().numel())
    return {
        "bytes": (3 * dst_rows + 2 * src_rows + 2 * nd + 2 * ns) * c * db
        + plan.idx.numel() * 4 + plan.meta.numel() * 4 + 3 * c * c * (db + 4) + 10 * c * 4,
        "flops": 9 * 2 * e * c * c,
        "edges": e,
        "slot_bytes": 2 * 8 * e * c * db,
    }
