"""The port's spill-plan aggregation (`pair_aggregate`), Att's fused edge MLP
(`fused_edge_mlp`) and the port's gather for the neighbour tables and the
fusion lists (`masked_gather`) against the JAX package, forward and
gradients, on CPU tensors (the plain versions and their autograd
Functions). The Pallas kernels run as the JAX tests run them on the CPU:
interpret mode; the JAX package's gathers (`stacked_table_gather`,
`sorted_transpose_gather`, with hand-written VJPs) are XLA. The spill
plan's preparation for the kernels (`prepare_spill`: relation order,
tiles, positions) against a numpy reference, the forward and backward
kernels' passes emulated on it, one preparation per LaneConv stack call
and per LaneGCN forward, and no `nonzero` in the plain versions.

Inputs come from a numpy seed and feed both sides; everything is float32.
Tolerances: forwards within 1e-5 absolute (1e-5 relative on the
accumulating outputs), as tests/test_torch_kernels.py; each gradient leaf
within 2e-5 · max(1, max |reference leaf|), as tests/test_torch_grads.py:
both sides sum the same fp32 products in other orders (~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.data.packing import build_pair_plan
from lanegcn_tpu.graph import PairPlan as JPairPlan
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_edge_mlp
from lanegcn_tpu.ops.pallas_pair_agg import pair_aggregate as jax_pair_agg
from lanegcn_tpu.ops.table_gather import sorted_transpose_gather as jax_stg
from lanegcn_tpu.ops.table_gather import stacked_table_gather as jax_table_gather

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import edge_mlp, masked_gather, pair_agg, scenario_agg, window_scatter
from lanegcn_tpu_torch.ops.segment_sum import segment_sum_plain

C = 128
ATOL = 1e-5
REL = 2e-5


def _close_fwd(port, ref, rtol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref, np.float32),
                               rtol=rtol, atol=ATOL)


def _close_grad(port, ref, what):
    port = port.detach().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = REL * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _leaves(arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]


def _port_grads(op, leaves, rest, g):
    out = op(*leaves, *rest)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction), out.grad_fn
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in leaves]


def _autograd_plain(plain, leaves, rest, g):
    fresh = [t.detach().clone().requires_grad_(True) for t in leaves]
    plain(*fresh, *rest).backward(torch.from_numpy(g))
    # A leaf the plain graph never reads (an empty plan's feat) gets no grad.
    return [torch.zeros_like(t) if t.grad is None else t.grad for t in fresh]


# --- pair_aggregate -------------------------------------------------------------

WIN, STRIDE, R, CHUNK = 5, 64, 14, 16
N = WIN * STRIDE


def _spill_case(seed, n_edges, cap, skip_dst, skip_src, rels=None, dst_win=None):
    """A spill plan and inputs; `rels` {relation: edges} fixes the relation
    counts, `dst_win` sends every edge into that destination window (one
    run of many chunks)."""
    rng = np.random.RandomState(seed)
    if rels is not None:
        n_edges = sum(rels.values())
    u = rng.randint(0, N, n_edges).astype(np.int64)
    v = rng.randint(0, N, n_edges).astype(np.int64)
    if dst_win is not None:
        u = dst_win * STRIDE + u % STRIDE
    keep = np.ones(n_edges, bool)
    if skip_dst is not None:
        keep &= (u // STRIDE != skip_dst) & (v // STRIDE != skip_src)
    u, v = u[keep], v[keep]
    # Relation-major order within a window pair, as the packer's residue is.
    if rels is not None:
        rel = np.repeat(np.array(list(rels), np.int32), list(rels.values()))
    else:
        rel = np.sort(rng.randint(0, R, len(u))).astype(np.int32)
    d, dropped, _ = build_pair_plan(u, v, STRIDE, STRIDE, cap, CHUNK, rel=rel,
                                    return_residue=True)
    assert dropped == 0
    idx = np.concatenate([d["lu"], d["lv"], d["rel"]], axis=1)
    meta = np.stack([d[k] for k in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
    arrays = [(rng.randn(N, C) * 0.2).astype(np.float32), (rng.randn(N, C) * 0.2).astype(np.float32),
              (rng.randn(R, C, C) * 0.1).astype(np.float32)]
    return arrays, idx, meta, rng.randn(N, C).astype(np.float32)


@pytest.mark.parametrize("case", [
    # Destination window 2 and source window 1 are never touched.
    dict(n_edges=300, cap=1024, skip_dst=2, skip_src=1),
    # Capacity well past the edges: all-padding tail chunks.
    dict(n_edges=40, cap=2048, skip_dst=None, skip_src=None),
    # No edge at all: one run of padding chunks.
    dict(n_edges=0, cap=256, skip_dst=None, skip_src=None),
    # Relation 3 has one edge, relations 1, 2, 4.. none.
    dict(n_edges=151, cap=1024, skip_dst=None, skip_src=None, rels={0: 90, 3: 1, 13: 60}),
    # Every edge into destination window 1: one run of many chunks.
    dict(n_edges=400, cap=1024, skip_dst=None, skip_src=None, dst_win=1),
], ids=["untouched-windows", "padding-chunks", "empty-plan", "one-edge-relation", "long-run"])
def test_pair_agg_matches_pallas(case):
    """The plain forward and backward (in the relation order the kernels
    sum in, over every plan slot) and their autograd Function against the
    Pallas kernel and its VJP in interpret mode."""
    arrays, idx, meta, g = _spill_case(21, case["n_edges"], case["cap"], case["skip_dst"],
                                       case["skip_src"], case.get("rels"), case.get("dst_win"))
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(meta), chunk=CHUNK,
                      dst_stride=STRIDE, src_stride=STRIDE)
    ref, vjp = jax.vjp(lambda *a: jax_pair_agg(*a, jplan, mode="interpret"),
                       *map(jnp.asarray, arrays))
    ref_grads = vjp(jnp.asarray(g))
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=CHUNK,
                    dst_stride=STRIDE, src_stride=STRIDE)
    leaves = _leaves(arrays)
    out, grads = _port_grads(pair_agg.pair_aggregate, leaves, (plan,), g)
    _close_fwd(out, ref, rtol=1e-5)
    names = ["feat", "temp", "w_rel"]
    for nm, got, want in zip(names, grads, ref_grads):
        _close_grad(got, want, f"pair_agg d{nm}")
    np.testing.assert_array_equal(grads[1].numpy(), g)  # temp's cotangent passes through
    for nm, got, want in zip(names, grads, _autograd_plain(pair_agg.pair_agg_plain, leaves,
                                                           (plan,), g)):
        _close_grad(got, want.numpy(), f"pair_agg d{nm} vs autograd")
    if case["skip_dst"] is not None:
        w = slice(case["skip_dst"] * STRIDE, (case["skip_dst"] + 1) * STRIDE)
        np.testing.assert_array_equal(out[w].detach().numpy(), arrays[1][w])  # keeps temp
        w = slice(case["skip_src"] * STRIDE, (case["skip_src"] + 1) * STRIDE)
        assert not grads[0][w].any()
    if case["n_edges"] == 0:
        np.testing.assert_array_equal(out.detach().numpy(), arrays[1])
        assert not grads[0].any() and not grads[2].any()


# --- the spill plan prepared for the backward kernel ---------------------------

# (edges or {relation: edges}, slot capacity, destination window of every
# edge or None, rows cut off the end of the arrays)
PREP_CASES = {
    "empty": (0, 256, None, 0),
    "padding-chunks": (40, 2048, None, 0),
    # relation 3: one edge; relations 1, 2, 4 .. 12: none
    "one-edge-relation": ({0: 90, 3: 1, 13: 60}, 1024, None, 0),
    # rows past n: the edges into or out of the last 40 rows are dropped
    "rows-past-n": (300, 1024, None, 40),
    "long-run": (400, 1024, 1, 0),
}


def _prep_case(name):
    spec, cap, dst_win, cut = PREP_CASES[name]
    rels = spec if isinstance(spec, dict) else None
    arrays, idx, meta, g = _spill_case(31, 0 if rels else spec, cap, None, None, rels, dst_win)
    n = N - cut
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=CHUNK,
                    dst_stride=STRIDE, src_stride=STRIDE)
    feat, _, w_rel = (torch.from_numpy(a) for a in arrays)
    return plan, idx, meta, n, feat[:n].contiguous(), w_rel, torch.from_numpy(g[:n].copy())


def _reference_spill(idx, meta, n):
    """prepare_spill in numpy, slot by slot: the valid rule, the stable
    relation order, the tiles, and the stable destination and source
    orders."""
    tile = scenario_agg.TILE
    ok, us, vs = [], [], []
    for slot in range(idx.shape[0]):
        lu, lv, r = (int(x) for x in idx[slot])
        ch = slot // CHUNK
        u, v = int(meta[0, ch]) * STRIDE + lu, int(meta[1, ch]) * STRIDE + lv
        ok.append(0 <= lu < STRIDE and 0 <= lv < STRIDE and 0 <= r < R and u < n and v < n)
        us.append(u)
        vs.append(v)
    ok = np.array(ok)
    key = np.where(ok, idx[:, 2], R)
    order = np.argsort(key, kind="stable")[: int(ok.sum())]
    u, v = np.array(us)[order], np.array(vs)[order]
    counts = np.bincount(key[order], minlength=R)
    starts = np.concatenate([[0], np.cumsum(counts)])
    tiles = [(r, starts[r] + j, min(tile, counts[r] - j))
             for r in range(R) for j in range(0, counts[r], tile)]
    ntiles = np.concatenate([[0], np.cumsum(-(-counts // tile))])
    dperm, sperm = np.argsort(u, kind="stable"), np.argsort(v, kind="stable")
    dpos, spos = np.empty_like(dperm), np.empty_like(sperm)
    dpos[dperm], spos[sperm] = np.arange(len(u)), np.arange(len(u))
    return dict(u=u, v=v, rel_edges=starts, rel_tiles=ntiles,
                tiles=np.array(tiles, np.int64).reshape(-1, 3), dpos=dpos, dseg=u[dperm],
                spos=spos, sseg=v[sperm])


@pytest.mark.parametrize("name", list(PREP_CASES))
def test_prepare_spill_matches_numpy_reference(name):
    plan, idx, meta, n, *_ = _prep_case(name)
    ref = _reference_spill(idx, meta, n)
    p = pair_agg.prepare_spill(plan, n, R)
    slots, e = idx.shape[0], len(ref["u"])
    np.testing.assert_array_equal(p.dst[:e].numpy(), ref["u"])
    np.testing.assert_array_equal(p.src[:e].numpy(), ref["v"])
    assert (p.dst[e:] == n).all() and (p.src[e:] == n).all()
    np.testing.assert_array_equal(p.rel_edges.numpy(), ref["rel_edges"])
    np.testing.assert_array_equal(p.rel_tiles.numpy(), ref["rel_tiles"])
    t = len(ref["tiles"])
    assert p.tiles.shape == (-(-slots // scenario_agg.TILE) + R, 3)
    np.testing.assert_array_equal(p.tiles[:t].numpy(), ref["tiles"])
    assert (p.tiles[t:, 0] == -1).all() and (p.tiles[t:, 1:] == 0).all()
    for k in ("dpos", "spos", "dseg", "sseg"):
        np.testing.assert_array_equal(getattr(p, k)[:e].numpy(), ref[k], err_msg=k)
    assert (p.dseg[e:] == n).all() and (p.sseg[e:] == n).all()
    assert p.rows == n
    if name == "empty":
        assert e == 0 and t == 0
    if name == "one-edge-relation":
        counts = np.diff(ref["rel_edges"])
        assert counts[3] == 1 and counts[1] == 0 and (e, t) == (151, 2 + 1 + 1)
    if name == "rows-past-n":
        assert 0 < e < int((idx[:, 0] >= 0).sum())
    if name == "long-run":
        assert (ref["u"] // STRIDE == 1).all() and int(plan.first.sum()) == 1
        assert int((meta[0] == 1).sum()) > 3  # the run spans several chunks


def test_spill_preparation_for_other_sizes_raises():
    """A handed-in preparation is taken only for the plan's slots, the
    weights' relations and feat's rows (its segment keys mark the positions
    past the valid edges with n); a forward-only one is remade for the
    backward."""
    plan, _, _, n, *_ = _prep_case("rows-past-n")
    fwd = pair_agg.prepare_spill(plan, n, R, backward=False)
    assert pair_agg._prep_for(plan, n, R, fwd, False) is fwd
    assert pair_agg._prep_for(plan, n, R, fwd, True).spos is not None
    for rows, rels in ((n + 40, R), (n, R - 1)):
        with pytest.raises(ValueError, match="prepared for"):
            pair_agg._prep_for(plan, rows, rels, fwd, False)
    other, *_ = _prep_case("padding-chunks")
    with pytest.raises(ValueError, match="prepared for"):
        pair_agg._prep_for(other, n, R, fwd, False)


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("name", list(PREP_CASES))
def test_spill_passes_emulated_match_the_plain_version(name, direction):
    """The kernels' passes over prepare_spill, on the CPU. Forward (over the
    forward-only preparation): each edge's fp32 message W_r · feat[v] at its
    destination position, then the segment sum over the destination order
    from temp, is bitwise pair_agg_plain. Backward: each edge's fp32 message
    g[u] @ W_rᵀ at its source position, then the segment sum over the source
    order, is bitwise pair_agg_bwd_plain's dfeat; dW_r summed tile by tile
    over the relation-pure tiles matches its dW."""
    plan, _, _, n, feat, w_rel, g = _prep_case(name)
    p = pair_agg.prepare_spill(plan, n, R, backward=direction == "backward")
    e = int(p.rel_edges[-1])
    dst, src = p.dst[:e].long(), p.src[:e].long()
    counts = (p.rel_edges[1:] - p.rel_edges[:-1]).tolist()
    ws = torch.zeros(plan.idx.shape[0], C)
    if direction == "forward":
        assert p.spos is None and p.sseg is None
        temp = g * 0.5
        ws[p.dpos[:e].long()] = scenario_agg._per_relation(feat[src], w_rel, counts)
        out = segment_sum_plain(ws, p.dseg, n, temp)
        assert torch.equal(out, pair_agg.pair_agg_plain(feat, temp, w_rel, plan))
        return
    ws[p.spos[:e].long()] = scenario_agg._per_relation(g[dst], w_rel, counts, transpose=True)
    dfeat = segment_sum_plain(ws, p.sseg, n)
    plain_dfeat, plain_dw = pair_agg.pair_agg_bwd_plain(feat, w_rel, plan, g)
    assert torch.equal(dfeat, plain_dfeat)
    dw = torch.zeros(R, C, C)
    for r, first, cnt in p.tiles.tolist():
        if r >= 0:
            rows = slice(first, first + cnt)
            dw[r] += feat[p.src[rows].long()].t() @ g[p.dst[rows].long()]
    _close_grad(dw, plain_dw.numpy(), f"{name} dW_rel by tiles")


def _spill_world():
    """A two-scenario bench pack whose window plan is cut small, so that its
    residue rides the spill plan, and a narrow model config."""
    import dataclasses

    from lanegcn_tpu_torch.config import ModelConfig, bench_pack_config
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
    from lanegcn_tpu_torch.graph import PackedBatch

    model = ModelConfig(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=1,
                        merge_plan_agg="off")
    scens = [make_urban_scenario(seed=40 + i, num_corridors=3, num_actors=6) for i in range(2)]
    cfg = dataclasses.replace(bench_pack_config(2), max_plan_edges=512)
    b, st = pack_batch(scens, cfg, model)
    assert st["spill_pair_edges"] > 0
    return model, PackedBatch.from_numpy(b)


def _count_spill(monkeypatch):
    """Records every prepare_spill (with its `backward` flag), the prep each
    pair_aggregate is handed and the prep each plain backward walks."""
    from lanegcn_tpu_torch.models import map_net

    made, seen, used = [], [], []
    prepare, aggregate, bwd = map_net.prepare_spill, map_net.pair_aggregate, \
        pair_agg.pair_agg_bwd_plain

    def counted_prepare(*a, **kw):
        made.append(prepare(*a, **kw))
        return made[-1]

    def counted_aggregate(*a):
        seen.append(a[4])
        return aggregate(*a)

    def counted_bwd(*a):
        used.append(a[-1])
        return bwd(*a)

    monkeypatch.setattr(map_net, "prepare_spill", counted_prepare)
    monkeypatch.setattr(map_net, "pair_aggregate", counted_aggregate)
    monkeypatch.setattr(pair_agg, "pair_agg_bwd_plain", counted_bwd)
    return made, seen, used


def test_stack_prepares_the_spill_plan_once_per_call(monkeypatch):
    """A LaneConvStack called alone makes one prepare_spill per call, with
    the source order when a gradient is wanted and forward-only when
    serving, handed to every layer's pair_aggregate and used by its
    backward."""
    from lanegcn_tpu_torch.models import map_net
    from lanegcn_tpu_torch.models.layers import init_parameters

    model, batch = _spill_world()
    graph = batch.graph
    stack = map_net.LaneConvStack(model, 2)
    init_parameters(stack, seed=0)
    made, seen, used = _count_spill(monkeypatch)
    feat = torch.randn(graph.capacity, 32, requires_grad=True)
    out = stack(feat, **map_net.graph_inputs(graph))
    out.square().mean().backward()
    assert len(made) == 1 and made[0].spos is not None
    assert len(seen) == 2 and all(s is made[0] for s in seen)
    assert len(used) == 2 and all(u is made[0] for u in used)
    with torch.no_grad():
        stack(feat, **map_net.graph_inputs(graph))
    assert len(made) == 2 and made[1].spos is None and made[1].sseg is None
    assert len(seen) == 4 and seen[2] is made[1] and seen[3] is made[1]


def test_lanegcn_prepares_the_spill_plan_once_per_forward(monkeypatch):
    """A LaneGCN forward makes one prepare_spill in all, shared by MapNet's
    and M2M's stacks (every layer's pair_aggregate) and by their backwards;
    serving makes one forward-only."""
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN

    model, batch = _spill_world()
    net = LaneGCN(model, device="cpu", seed=0)
    made, seen, used = _count_spill(monkeypatch)
    out = net(batch)
    (out["reg"].square().mean() + out["cls"].square().mean()).backward()
    layers = 2 * model.num_fuse_layers  # MapNet's stack and M2M's
    assert len(made) == 1 and made[0].spos is not None
    assert len(seen) == layers and all(s is made[0] for s in seen)
    assert len(used) == layers and all(u is made[0] for u in used)
    with torch.no_grad():
        net(batch)
    assert len(made) == 2 and made[1].spos is None
    assert len(seen) == 2 * layers and all(s is made[1] for s in seen[layers:])


def test_plain_versions_make_no_nonzero():
    """pair_agg's and window_scatter's plain versions run over every slot
    (zero padding rows, no compaction): no aten::nonzero."""
    from torch.profiler import ProfilerActivity, profile

    plan, _, _, n, feat, w_rel, g = _prep_case("rows-past-n")
    rng = np.random.RandomState(3)
    lu = np.full((2 * window_scatter.WCHUNK, 1), -1, np.int32)
    lu[:300, 0] = rng.randint(0, 64, 300)
    lu[512:600, 0] = rng.randint(0, 64, 88)
    wchunk = torch.tensor([0, 2], dtype=torch.int32)
    msg = torch.randn(lu.shape[0], C)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pair_agg.pair_agg_plain(feat, g, w_rel, plan)
        pair_agg.pair_agg_bwd_plain(feat, w_rel, plan, g)
        out = window_scatter.window_scatter_plain(msg, torch.zeros(3 * 64, C),
                                                  torch.from_numpy(lu), wchunk, 64)
    assert "aten::nonzero" not in {e.name for e in prof.events()}
    ref = torch.zeros(3 * 64, C)
    for e in np.flatnonzero(lu[:, 0] >= 0):
        ref[int(wchunk[e // 512]) * 64 + int(lu[e, 0])] += msg[e]
    _close_fwd(out, ref.numpy(), rtol=1e-6)


# --- fused_edge_mlp ---------------------------------------------------------------

def _edge_case(seed, e, n_pad):
    """e rows whose last n_pad are padding: zero inputs, zero cotangent (the
    masked scatter drops them)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    d = (rng.randn(e, 2) * 3.0).astype(np.float32)
    qg, cg = r(e, C), r(e, C)
    g = rng.randn(e, C).astype(np.float32)
    for a in (d, qg, cg, g):
        a[e - n_pad:] = 0.0
    arrays = [d, qg, cg, r(2, C), r(C), r(C, C), r(C) + 1.0, r(C), r(C, C), r(C) + 1.0, r(C),
              r(C, C)]
    return arrays, g


def test_edge_mlp_matches_pallas():
    """700 rows (two 512-row Pallas tiles, a ragged 64-row tail here), the
    last 150 padding: their outputs agree too, and they add nothing to any
    gradient."""
    e, n_pad = 700, 150
    arrays, g = _edge_case(22, e, n_pad)

    def jfn(*a):
        return jax_edge_mlp(*a, True, True, 1e-5, True)

    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref_grads = vjp(jnp.asarray(g))
    leaves = _leaves(arrays)
    out, grads = _port_grads(edge_mlp.fused_edge_mlp, leaves, (), g)
    _close_fwd(out, ref)
    names = ["d", "qg", "cg", "kd", "bd", "kdo", "gdow", "gdob", "k1", "gchw", "gchb", "kout"]
    for nm, got, want in zip(names, grads, ref_grads):
        _close_grad(got, want, f"edge_mlp d{nm}")
    for nm, got, want in zip(names, grads, _autograd_plain(edge_mlp.edge_mlp_plain, leaves, (),
                                                           g)):
        _close_grad(got, want.numpy(), f"edge_mlp d{nm} vs autograd")
    # Padding rows: one constant output row; exactly zero per-row cotangents.
    tail = out[e - n_pad:].detach().numpy()
    np.testing.assert_allclose(tail, np.broadcast_to(tail[:1], tail.shape), rtol=0, atol=1e-6)
    for t in grads[:3]:
        assert not t[e - n_pad:].any()
    # The parameter gradients are those of the valid rows alone.
    valid = [torch.from_numpy(a[: e - n_pad].copy()) for a in arrays[:3]]
    sub = edge_mlp.edge_mlp_bwd_plain(*valid, *map(torch.from_numpy, arrays[3:]),
                                      torch.from_numpy(g[: e - n_pad].copy()))
    for nm, got, want in zip(names[3:], grads[3:], sub[3:]):
        _close_grad(got, want.numpy(), f"edge_mlp d{nm} vs valid rows only")


# --- the gathers --------------------------------------------------------------------

def test_stacked_table_gather_matches_jax():
    """The neighbour-table rows as the port's LaneConvStack gathers them."""
    rng = np.random.RandomState(23)
    n, r, c = 60, 2, 16
    tables = rng.randint(0, n, (r, n)).astype(np.int32)
    tables[rng.rand(r, n) < 0.3] = n  # no neighbour
    src = [k * n + u for k in range(r) for u in range(n) if tables[k, u] < n]
    dst = [tables[k, u] for k in range(r) for u in range(n) if tables[k, u] < n]
    order = np.argsort(dst, kind="stable")
    cap = len(src) + 7
    inv_src = np.full(cap, r * n, np.int32)
    inv_dst = np.full(cap, n, np.int32)
    inv_src[: len(src)] = np.asarray(src)[order]
    inv_dst[: len(dst)] = np.asarray(dst)[order]
    feat = rng.randn(n, c).astype(np.float32)
    g = rng.randn(r, n, c).astype(np.float32)
    ref, vjp = jax.vjp(lambda f: jax_table_gather(f, jnp.asarray(tables), jnp.asarray(inv_src),
                                                  jnp.asarray(inv_dst)), jnp.asarray(feat))
    (ref_grad,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(feat).requires_grad_(True)
    tables_t = torch.from_numpy(tables).long()
    out = masked_gather(leaf, tables_t, tables_t < n)
    out.backward(torch.from_numpy(g))
    _close_fwd(out, ref)
    _close_grad(leaf.grad, ref_grad, "table rows dfeat")


@pytest.mark.parametrize("ident", [False, True], ids=["source-order", "destination-order"])
def test_sorted_transpose_gather_matches_jax(ident):
    """Att's gathers as the port runs them (`masked_gather`) against the JAX
    package's: the context gather (inv_perm, inv_dst from the packer) and
    the query gather (the identity order over a destination-sorted list)."""
    rng = np.random.RandomState(24)
    s, e, n_valid, c = 40, 90, 70, 16
    idx = np.zeros(e, np.int32)
    idx[:n_valid] = np.sort(rng.randint(0, s, n_valid)) if ident else rng.randint(0, s, n_valid)
    mask = np.arange(e) < n_valid
    if ident:
        inv_perm = np.arange(e, dtype=np.int32)
        inv_dst = np.where(mask, idx, s).astype(np.int32)
    else:
        inv_perm = np.full(e, e - 1, np.int32)
        inv_dst = np.full(e, s, np.int32)
        o = np.argsort(idx[:n_valid], kind="stable").astype(np.int32)
        inv_perm[:n_valid] = o
        inv_dst[:n_valid] = idx[:n_valid][o]
    x = rng.randn(s, c).astype(np.float32)
    g = rng.randn(e, c).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_stg(a, jnp.asarray(idx), jnp.asarray(mask),
                                         jnp.asarray(inv_perm), jnp.asarray(inv_dst)),
                       jnp.asarray(x))
    (ref_grad,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = masked_gather(leaf, torch.from_numpy(idx).long(), torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    _close_fwd(out, ref)
    _close_grad(leaf.grad, ref_grad, "edge-list gather dx")
