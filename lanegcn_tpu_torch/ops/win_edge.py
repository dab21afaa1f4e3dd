"""Window-pair fused edge MLP + destination scatter (forward): the
`win_edge` CUDA kernel (csrc/win_edge.cu) and its plain version.

Per planned edge (u ← v):
    t1 = relu(Pd[u] + Ps[v] + bd);  t2 = relu(GN(t1 @ Wdo))
    s  = t2 @ K1 + Cs[v] + Qd[u];   e1 = relu(GN(s))
    out[u] += e1 @ Wout             (out starts as temp)

Counterpart of lanegcn_tpu/ops/pallas_win_edge.py `win_edge_mlp` with
has_dist2 and has_query (the Att configuration). The caller folds the
distance embedding's signs into Pd/Ps.
"""

from __future__ import annotations

import ctypes

import torch

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import cuda
from lanegcn_tpu_torch.ops.norm import group_norm


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


def win_edge_mlp(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout,
                 plan: PairPlan, eps: float = 1e-5) -> torch.Tensor:
    """temp + scatter(edge MLP over the window-pair plan).

    pd/qd/temp [Nd, 128], ps/cs [Ns, 128] in one activation dtype; bd and
    GN affines [128] fp32; kdo/k1/kout [128, 128] (in, out), cast to the
    activation dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel. Destination windows no chunk touches keep temp: the
    kernel updates a clone of temp.
    """
    if pd.device.type == "cpu":
        return win_edge_plain(pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb,
                              kout, plan, eps)
    if pd.device.type != "cuda":
        raise ValueError(f"win_edge: unsupported device {pd.device}")
    nd, c = pd.shape
    ns = ps.shape[0]
    dt = pd.dtype
    nc = plan.num_chunks
    if (c != 128 or qd.shape != pd.shape or temp.shape != pd.shape or cs.shape != ps.shape
            or ps.shape[1] != c
            or any(tuple(w.shape) != (c, c) for w in (kdo, k1, kout))
            or any(tuple(p.shape) != (c,) for p in (bd, gdow, gdob, gchw, gchb))
            or plan.idx.dim() != 2 or plan.idx.shape[0] != nc * plan.chunk
            or plan.idx.shape[1] < 2 or tuple(plan.meta.shape) != (6, nc)):
        raise ValueError(f"win_edge: bad shapes pd {pd.shape} ps {ps.shape} "
                         f"plan idx {plan.idx.shape} meta {plan.meta.shape}")
    if any(t.dtype != dt for t in (qd, ps, cs, temp)):
        raise TypeError("win_edge: pd, qd, ps, cs and temp must share one dtype")
    if plan.idx.dtype != torch.int32 or plan.meta.dtype != torch.int32:
        raise TypeError("win_edge: plan indices must be int32")
    ws = [w.to(dt).contiguous() for w in (kdo, k1, kout)]
    vs = [p.float().contiguous() for p in (bd, gdow, gdob, gchw, gchb)]
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
        ctypes.c_int(nc), ctypes.c_int(plan.chunk), ctypes.c_int(plan.dst_stride),
        ctypes.c_int(plan.src_stride), ctypes.c_int(plan.idx.shape[1]), ctypes.c_int(nd),
        ctypes.c_int(ns), ctypes.c_float(eps), ctypes.c_int(code), cuda.stream(),
    )
    return out


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
