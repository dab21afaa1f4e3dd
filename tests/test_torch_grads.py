"""Gradients of the port's kernel ops on CPU tensors — their
`torch.autograd.Function`s running the plain backward versions — against
the JAX package's hand-written VJPs of the Pallas kernels, run as the JAX
tests run them on the CPU (interpret mode), and against torch.autograd of
each op's own plain forward.

Inputs come from a numpy seed and feed both sides; everything is float32.
Tolerance: each gradient leaf within 2e-5 · max(1, max |reference leaf|).
Both sides sum the same fp32 products in different orders (the Pallas
kernels in 1024-row tiles and per-chunk one-hot matmuls, the plain versions
as whole matmuls and index_add_); parameter gradients are sums over
hundreds of rows, so their reorder error is ~1e-6 of their largest element,
and 2e-5 leaves 10-20x room.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.data.packing import build_pair_plan
from lanegcn_tpu.graph import PairPlan as JPairPlan
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer as jax_lane_layer
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail as jax_row_tail
from lanegcn_tpu.ops.pallas_scenario_agg import scenario_aggregate as jax_scenario_agg
from lanegcn_tpu.ops.pallas_win_edge import win_edge_mlp as jax_win_edge

from lanegcn_tpu_torch.data.packing import window_chunked_edges
from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import band_conv, edge_mlp, lane_layer, row_tail, scenario_agg, win_edge
from lanegcn_tpu_torch.ops import window_scatter

C = 128
REL = 2e-5
SHIFTS = tuple(s for k in range(6) for s in (-(1 << k), 1 << k))
LR, DIL = (12, 13), tuple(range(12))


def _close(port, ref, what):
    port = port.detach().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = REL * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _leaves(arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]


def _port_grads(op, leaves, rest, g):
    """Leaf gradients of op(*leaves, *rest) for cotangent g, through the
    op's autograd Function."""
    out = op(*leaves, *rest)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction), out.grad_fn
    out.backward(torch.from_numpy(g))
    return [t.grad for t in leaves]


def _autograd_plain(plain, leaves, rest, g):
    fresh = [t.detach().clone().requires_grad_(True) for t in leaves]
    plain(*fresh, *rest).backward(torch.from_numpy(g))
    return [t.grad for t in fresh]


def _gn_params(rng, k):
    return [a for _ in range(k) for a in ((1.0 + 0.1 * rng.randn(C)).astype(np.float32),
                                          (0.1 * rng.randn(C)).astype(np.float32))]


# --- row_tail ---------------------------------------------------------------

@pytest.mark.parametrize("n", [300, 1024], ids=["ragged-rows", "tile-rows"])
def test_row_tail_grads_match_pallas_vjp(n):
    rng = np.random.RandomState(11)
    arrays = [rng.randn(n, C).astype(np.float32), rng.randn(n, C).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32), *_gn_params(rng, 2)]
    g = rng.randn(n, C).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_row_tail(*a, mode="interpret"), *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(arrays)
    grads = _port_grads(row_tail.fused_row_tail, leaves, (), g)
    names = ["x", "res", "w", "g1w", "g1b", "g2w", "g2b"]
    for nm, got, want in zip(names, grads, ref):
        _close(got, want, f"row_tail d{nm}")
    for nm, got, want in zip(names, grads, _autograd_plain(row_tail.row_tail_plain, leaves, (), g)):
        _close(got, want.numpy(), f"row_tail d{nm} vs autograd")


# --- lane_layer ---------------------------------------------------------------

@pytest.mark.parametrize("ends", [False, True], ids=["random-bands", "bands-at-ends"])
def test_lane_layer_grads_match_pallas_vjp(ends):
    rng = np.random.RandomState(12)
    n, j = 256, len(SHIFTS)
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    if ends:
        # Band rows whose source falls outside [0, N): no gradient flows there.
        masks[:, :32] = 1.0
        masks[:, -32:] = 1.0
    arrays = [rng.randn(n, C).astype(np.float32), rng.randn(n, C).astype(np.float32),
              (rng.randn(j, C, C) / np.sqrt(C)).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32), *_gn_params(rng, 2)]
    g = rng.randn(n, C).astype(np.float32)
    jm = jnp.asarray(masks)

    def jfn(feat, pre, wb, w2, g1w, g1b, g2w, g2b):
        return jax_lane_layer(feat, pre, jm, wb, w2, g1w, g1b, g2w, g2b, SHIFTS, 1e-5, True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(arrays)
    tm = torch.from_numpy(masks) > 0

    def port(feat, pre, wb, w2, *gn):
        return lane_layer.fused_lane_layer(feat, pre, tm, wb, w2, *gn, SHIFTS)

    def plain(feat, pre, wb, w2, *gn):
        return lane_layer.lane_layer_plain(feat, pre, tm, wb, w2, *gn, SHIFTS)

    grads = _port_grads(port, leaves, (), g)
    names = ["feat", "pre", "wb", "w2", "g1w", "g1b", "g2w", "g2b"]
    for nm, got, want in zip(names, grads, ref):
        _close(got, want, f"lane_layer d{nm}")
    for nm, got, want in zip(names, grads, _autograd_plain(plain, leaves, (), g)):
        _close(got, want.numpy(), f"lane_layer d{nm} vs autograd")


# --- scenario_agg --------------------------------------------------------------

def _plan_case(seed, num_win, stride, ecap, grouped, fill):
    rng = np.random.RandomState(seed)
    lu = np.full((num_win, ecap), -1, np.int32)
    lv = lu.copy()
    rel = lu.copy()
    for w in range(num_win):
        if grouped:
            k_lr, k_dil = fill[w]
            lu[w, :k_lr] = rng.randint(0, stride, k_lr)
            lv[w, :k_lr] = rng.randint(0, stride, k_lr)
            rel[w, :k_lr] = rng.choice(LR, k_lr)
            o = -(-k_lr // 512) * 512
            lu[w, o:o + k_dil] = rng.randint(0, stride, k_dil)
            lv[w, o:o + k_dil] = rng.randint(0, stride, k_dil)
            rel[w, o:o + k_dil] = np.sort(rng.choice(DIL, k_dil))
        else:
            lu[w, :fill[w]] = rng.randint(0, stride, fill[w])
            lv[w, :fill[w]] = rng.randint(0, stride, fill[w])
            rel[w, :fill[w]] = rng.randint(0, 14, fill[w])
    n = num_win * stride
    arrays = [rng.randn(n, C).astype(np.float32), rng.randn(n, C).astype(np.float32),
              (rng.randn(14, C, C) / np.sqrt(C)).astype(np.float32)]
    g = rng.randn(n, C).astype(np.float32)
    return arrays, [a.reshape(-1, 1) for a in (lu, lv, rel)], g


@pytest.mark.parametrize("case", [
    # Grouped layout; window 1 holds only all-padding chunks.
    dict(grouped=True, ecap=1024, fill=[(300, 500), (0, 0)]),
    # Grouped layout, left/right group spanning two chunks.
    dict(grouped=True, ecap=3 * 512, fill=[(600, 100), (10, 400)]),
    # Single-group plan with ragged valid counts.
    dict(grouped=False, ecap=256, fill=[100, 7]),
], ids=["grouped-padding-window", "grouped-two-chunk-lr", "single-group"])
def test_scenario_agg_grads_match_pallas_vjp(case):
    arrays, plan, g = _plan_case(13, 2, 256, case["ecap"], case["grouped"], case["fill"])
    groups = (LR, DIL) if case["grouped"] else None
    jplan = [jnp.asarray(a) for a in plan]

    def jfn(feat, temp, w_rel):
        return jax_scenario_agg(feat, temp, w_rel, *jplan, num_scen=2, mode="interpret",
                                groups=groups)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(arrays)
    tplan = tuple(torch.from_numpy(a) for a in plan)
    grads = _port_grads(scenario_agg.scenario_aggregate, leaves, tplan + (2, groups), g)
    for nm, got, want in zip(["feat", "temp", "w_rel"], grads, ref):
        _close(got, want, f"scenario_agg d{nm}")
    np.testing.assert_array_equal(grads[1].numpy(), g)  # temp's cotangent passes through
    auto = _autograd_plain(scenario_agg.scenario_agg_plain, leaves, tplan + (2, groups), g)
    for nm, got, want in zip(["feat", "temp", "w_rel"], grads, auto):
        _close(got, want.numpy(), f"scenario_agg d{nm} vs autograd")
    if case["fill"][1] == (0, 0):
        # The all-padding window: its feat rows get no gradient.
        assert not grads[0][256:].any()


# --- win_edge ------------------------------------------------------------------

def _pair_case(seed, n_edges, sd, ss, nd_win, ns_win, cap, chunk, skip_dst, skip_src):
    rng = np.random.RandomState(seed)
    nd, ns = sd * nd_win, ss * ns_win
    u = rng.randint(0, nd, n_edges)
    v = rng.randint(0, ns, n_edges)
    keep = np.ones(n_edges, bool)
    if skip_dst is not None:
        keep &= (u // sd) != skip_dst
    if skip_src is not None:
        keep &= (v // ss) != skip_src
    d, dropped = build_pair_plan(u[keep], v[keep], sd, ss, cap, chunk)
    assert dropped == 0
    idx = np.concatenate([d["lu"], d["lv"]], axis=1)
    meta = np.stack([d[k] for k in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    arrays = [r(nd, C), r(nd, C), r(ns, C), r(ns, C), r(nd, C),
              r(C), r(C, C), r(C) + 1.0, r(C), r(C, C), r(C) + 1.0, r(C), r(C, C)]
    return arrays, idx, meta, rng.randn(nd, C).astype(np.float32)


@pytest.mark.parametrize("case", [
    # Destination window 2 and source window 1 are never touched.
    dict(n_edges=300, skip_dst=2, skip_src=1, cap=1024),
    # Capacity well past the edges: all-padding tail chunks.
    dict(n_edges=40, skip_dst=None, skip_src=None, cap=2048),
], ids=["untouched-windows", "padding-chunks"])
def test_win_edge_grads_match_pallas_vjp(case):
    sd, ss, chunk = 32, 16, 16
    arrays, idx, meta, g = _pair_case(14, case["n_edges"], sd, ss, 5, 3, case["cap"], chunk,
                                      case["skip_dst"], case["skip_src"])
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(meta), chunk=chunk,
                      dst_stride=sd, src_stride=ss)
    _, vjp = jax.vjp(lambda *a: jax_win_edge(*a, jplan, True, True, mode="interpret"),
                     *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                    dst_stride=sd, src_stride=ss)
    leaves = _leaves(arrays)
    grads = _port_grads(win_edge.win_edge_mlp, leaves, (plan,), g)
    names = ["pd", "qd", "ps", "cs", "temp", "bd", "kdo", "gdow", "gdob", "k1", "gchw", "gchb",
             "kout"]
    for nm, got, want in zip(names, grads, ref):
        _close(got, want, f"win_edge d{nm}")
    auto = _autograd_plain(win_edge.win_edge_plain, leaves, (plan,), g)
    for nm, got, want in zip(names, grads, auto):
        _close(got, want.numpy(), f"win_edge d{nm} vs autograd")
    if case["skip_dst"] is not None:
        w = slice(case["skip_dst"] * sd, (case["skip_dst"] + 1) * sd)
        assert not grads[0][w].any() and not grads[1][w].any()
        w = slice(case["skip_src"] * ss, (case["skip_src"] + 1) * ss)
        assert not grads[2][w].any() and not grads[3][w].any()


# --- the Functions on CPU tensors ---------------------------------------------------

def test_public_ops_backprop_through_their_function(monkeypatch):
    """On CPU tensors that require grad each public op's output carries its
    autograd Function, and backward runs that op's plain backward once."""
    rng = np.random.RandomState(15)
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((row_tail, "row_tail_bwd_plain"), (lane_layer, "lane_layer_bwd_plain"),
                      (scenario_agg, "scenario_agg_bwd_plain"), (win_edge, "win_edge_bwd_plain"),
                      (window_scatter, "window_scatter_bwd_plain"),
                      (row_tail, "row_tail2_bwd_plain"), (edge_mlp, "edge_mlp_pool_bwd_plain"),
                      (edge_mlp, "edge_mlp_bwd_plain"), (band_conv, "band_conv_bwd_plain")):
        counted(mod, name)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).requires_grad_(True)
    gn = [torch.ones(C), torch.zeros(C), torch.ones(C), torch.zeros(C)]
    outs = {
        "row_tail_bwd_plain": row_tail.fused_row_tail(t(70, C), t(70, C), t(C, C), *gn),
        "lane_layer_bwd_plain": lane_layer.fused_lane_layer(
            t(64, C), t(64, C), torch.ones(2, 64, dtype=torch.bool), t(2, C, C), t(C, C), *gn,
            (1, -2)),
    }
    outs["band_conv_bwd_plain"] = band_conv.band_conv(
        t(64, C), torch.ones(2, 64, dtype=torch.bool), t(2, C, C), (1, -2))
    arrays, plan, _ = _plan_case(16, 2, 256, 256, False, [20, 3])
    feat, temp, w_rel = (torch.from_numpy(a).requires_grad_(True) for a in arrays)
    outs["scenario_agg_bwd_plain"] = scenario_agg.scenario_aggregate(
        feat, temp, w_rel, *(torch.from_numpy(a) for a in plan), 2)
    arrays, idx, meta, _ = _pair_case(17, 50, 32, 16, 2, 2, 256, 16, None, None)
    pplan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=16,
                     dst_stride=32, src_stride=16)
    outs["win_edge_bwd_plain"] = win_edge.win_edge_mlp(
        *(torch.from_numpy(a).requires_grad_(True) for a in arrays), pplan)
    es, _ = window_chunked_edges(rng.randint(0, 256, 300), rng.randint(0, 50, 300), 1024, 128,
                                 50)
    outs["window_scatter_bwd_plain"] = window_scatter.window_scatter_add(
        t(1024, C), t(256, C), torch.from_numpy(es.win_lu), torch.from_numpy(es.win_chunk), 128)
    outs["row_tail2_bwd_plain"] = row_tail.fused_row_tail2(t(70, C), t(70, C), t(C, C), t(C, C),
                                                           *gn, torch.ones(C), torch.zeros(C))
    outs["edge_mlp_pool_bwd_plain"] = edge_mlp.fused_edge_mlp(
        t(90, 4), None, t(90, C), t(4, C), t(C), None, None, None, t(C, C), torch.ones(C),
        torch.zeros(C), t(C, C), False, False)
    outs["edge_mlp_bwd_plain"] = edge_mlp.fused_edge_mlp(
        t(90, 2), t(90, C), t(90, C), t(2, C), t(C), t(C, C), torch.ones(C), torch.zeros(C),
        t(C, C), torch.ones(C), torch.zeros(C), t(C, C))
    functions = {"row_tail_bwd_plain": "_RowTailBackward",
                 "lane_layer_bwd_plain": "_LaneLayerBackward",
                 "scenario_agg_bwd_plain": "_ScenarioAggBackward",
                 "win_edge_bwd_plain": "_WinEdgeBackward",
                 "window_scatter_bwd_plain": "_WindowScatterBackward",
                 "row_tail2_bwd_plain": "_RowTail2Backward",
                 "edge_mlp_pool_bwd_plain": "_EdgeMlpPoolBackward",
                 "edge_mlp_bwd_plain": "_EdgeMlpBackward",
                 "band_conv_bwd_plain": "_BandConvBackward"}
    for name, out in outs.items():
        assert type(out.grad_fn).__name__ == functions[name], (name, out.grad_fn)
        out.sum().backward()
        assert calls.get(name) == 1, (name, calls)
    # Without a gradient the ops return plain tensors (no Function, no graph).
    with torch.no_grad():
        out = row_tail.fused_row_tail(t(8, C), t(8, C), t(C, C), *gn)
    assert out.grad_fn is None
