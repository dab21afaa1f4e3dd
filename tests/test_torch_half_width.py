"""The half-width LaneGCN (n_map = n_actor = 64) against the JAX package on
the CPU, and the kernel wrappers' width dispatch.

- The four forwards whose kernels take 64-wide rows (`lane_layer`,
  `scenario_agg`, `pair_agg`, `win_edge`): their plain versions at W = 64
  against the Pallas kernels in interpret mode (as the JAX tests run them on
  the CPU), on small plans, float32, with the tolerances of the 128-wide
  files they mirror: `lane_layer`, `scenario_agg` and `win_edge` within
  2e-5 of max(1, max |reference|) (tests/test_torch_lane_layer.py,
  test_torch_scenario_agg.py, test_torch_win_edge.py), `pair_agg` within
  1e-5 absolute and 1e-5 relative (tests/test_torch_pair_edge.py): both
  sides sum the same fp32 products in other orders.
- The half-width LaneGCN's eval forward and loss, with the weights of one
  JAX init carried across by the bridge, against the JAX LaneGCN on the
  same JAX-built pack: the spill and pair-plan layout of
  tests/test_torch_layouts.py (3 scenarios, node_stride 256: the window
  plan, the spill plan, the classic residue lists and the fusion pair plans
  all carry edges), float32, within 1e-4 of max(1, max |reference|), as
  tests/test_torch_model.py. The weights come from one numpy seed on the
  shapes of the JAX init (`jax.eval_shape`); one jit of the forward, no
  gradients.
- The wrappers' checks, called directly: the four forwards, band_conv and
  lane_plan, and their backwards, take 64 and 128 and refuse 96; the other
  kernels (window_scatter, the K = 2 row tail, LanePooling's edge MLP)
  refuse 64; each names its kernel and the width.
- `work()` at W = 64: W² products per masked band row and per row, per
  applied edge and per valid slot, three per valid pair-plan edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig
from lanegcn_tpu.data.packing import build_pair_plan
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.graph import PairPlan as JPairPlan
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer as jax_lane_layer
from lanegcn_tpu.ops.pallas_pair_agg import pair_aggregate as jax_pair_agg
from lanegcn_tpu.ops.pallas_scenario_agg import scenario_aggregate as jax_scenario_agg
from lanegcn_tpu.ops.pallas_win_edge import win_edge_mlp as jax_win_edge

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig
from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.ops import (band_conv, edge_mlp, lane_layer, pair_agg, row_tail,
                                   scenario_agg, win_edge, window_scatter)
from lanegcn_tpu_torch.train.loop import make_eval_step
from lanegcn_tpu_torch.utils.weights import load_jax_params

W = 64
REL = 2e-5
SHIFTS = tuple(s for k in range(6) for s in (-(1 << k), 1 << k))
MODEL = dict(n_map=W, n_actor=W, num_fuse_layers=2, num_att_layers=2)
PACK = dict(
    max_scenarios=3, max_actors=96, max_nodes=256 * 4, node_stride=256, max_plan_edges=64,
    table_relations=(), spill_pairs=True, max_spill_pair_edges=1024, pair_chunk=64,
    actor_stride=32, fusion_pairs=True, max_edges_scale0=512, max_edges_dilated=512,
    max_edges_lr=512, max_a2m_edges=6144, max_m2a_edges=6144, max_a2a_edges=1536)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, what, rel=REL):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


# --- the four plain forwards at W = 64 against the Pallas kernels ---------------

def _lane_layer():
    """193 rows (one past a bf16 block of 192), ±1 .. ±32 band masks; the
    Pallas kernel takes a multiple of 128 rows, so both sides' inputs are
    padded with zero rows, which the port reads outside [0, N) too."""
    rng = np.random.RandomState(1)
    n, big, j = 193, 256, len(SHIFTS)
    feat, pre = (rng.randn(n, W).astype(np.float32) for _ in range(2))
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    wb = (rng.randn(j, W, W) / np.sqrt(W)).astype(np.float32)
    w2 = (rng.randn(W, W) / np.sqrt(W)).astype(np.float32)
    gn = [(1.0 + 0.1 * rng.randn(W)).astype(np.float32), (0.1 * rng.randn(W)).astype(np.float32),
          (1.0 + 0.1 * rng.randn(W)).astype(np.float32), (0.1 * rng.randn(W)).astype(np.float32)]
    pad = lambda a: np.pad(a, ((0, big - n), (0, 0)))
    ref = jax_lane_layer(jnp.asarray(pad(feat)), jnp.asarray(pad(pre)),
                         jnp.asarray(np.pad(masks, ((0, 0), (0, big - n)))), jnp.asarray(wb),
                         jnp.asarray(w2), *map(jnp.asarray, gn), SHIFTS, 1e-5, True)
    t = torch.from_numpy
    port = lane_layer.lane_layer_plain(t(feat), t(pre), t(masks) > 0, t(wb), t(w2),
                                       *map(t, gn), SHIFTS)
    return port, np.asarray(ref)[:n], REL, 0.0


def _window_plan(rng):
    """Two 256-row windows of a grouped plan (left/right, then the dilated
    relations from the next 512-slot chunk), window 1 half as full: (lu,
    lv, rel as [2*1024, 1] int32, the groups, the applied edges)."""
    num_win, stride, ecap = 2, 256, 1024
    groups = ((12, 13), tuple(range(12)))
    lu = np.full((num_win, ecap), -1, np.int32)
    lv, rel = lu.copy(), lu.copy()
    counts = ((300, 500), (150, 250))
    for w, (k_lr, k_dil) in enumerate(counts):
        lu[w, :k_lr], lv[w, :k_lr] = rng.randint(0, stride, (2, k_lr))
        rel[w, :k_lr] = rng.choice(groups[0], k_lr)
        lu[w, 512:512 + k_dil], lv[w, 512:512 + k_dil] = rng.randint(0, stride, (2, k_dil))
        rel[w, 512:512 + k_dil] = np.sort(rng.choice(groups[1], k_dil))
    return [a.reshape(-1, 1) for a in (lu, lv, rel)], groups, sum(map(sum, counts))


def _scenario_agg():
    """The grouped window plan of `_window_plan` over 14 relations."""
    rng = np.random.RandomState(2)
    plan, groups, _ = _window_plan(rng)
    num_win, n, r_num = 2, 2 * 256, 14
    feat, temp = (rng.randn(n, W).astype(np.float32) for _ in range(2))
    w_rel = (rng.randn(r_num, W, W) / np.sqrt(W)).astype(np.float32)
    ref = jax_scenario_agg(jnp.asarray(feat), jnp.asarray(temp), jnp.asarray(w_rel),
                           *map(jnp.asarray, plan), num_scen=num_win, mode="interpret",
                           groups=groups)
    t = torch.from_numpy
    port = scenario_agg.scenario_agg_plain(t(feat), t(temp), t(w_rel), *map(t, plan), num_win,
                                           groups)
    return port, np.asarray(ref), REL, 0.0


def _pair_plan(rng, nwd, sd, nws, ss, n_edges, cap, chunk, rel=None):
    u = rng.randint(0, nwd * sd, n_edges)
    v = rng.randint(0, nws * ss, n_edges)
    d, dropped, *_ = build_pair_plan(u, v, sd, ss, cap, chunk, rel=rel,
                                     return_residue=rel is not None)
    assert dropped == 0
    cols = [d["lu"], d["lv"]] + ([d["rel"]] if rel is not None else [])
    meta = np.stack([d[k] for k in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
    return np.concatenate(cols, axis=1), meta


def _pair_agg():
    """A spill plan of 300 edges in 16-slot chunks over five 64-row windows,
    relation-major within a window pair, as the packer's residue."""
    rng = np.random.RandomState(3)
    nwin, stride, r_num, chunk = 5, 64, 14, 16
    rel = np.sort(rng.randint(0, r_num, 300)).astype(np.int32)
    idx, meta = _pair_plan(rng, nwin, stride, nwin, stride, 300, 1024, chunk, rel)
    n = nwin * stride
    feat, temp = ((rng.randn(n, W) * 0.2).astype(np.float32) for _ in range(2))
    w_rel = (rng.randn(r_num, W, W) * 0.1).astype(np.float32)
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(meta), chunk=chunk,
                      dst_stride=stride, src_stride=stride)
    ref = jax_pair_agg(jnp.asarray(feat), jnp.asarray(temp), jnp.asarray(w_rel), jplan,
                       mode="interpret")
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                    dst_stride=stride, src_stride=stride)
    port = pair_agg.pair_agg_plain(*map(torch.from_numpy, (feat, temp, w_rel)), plan)
    return port, np.asarray(ref), 1e-5, 1e-5


def _win_edge():
    """An A2M-like pair plan: 300 edges from three 16-row source windows
    into five 32-row destination windows, in 1024 slots of 16-slot chunks."""
    rng = np.random.RandomState(4)
    (nwd, sd), (nws, ss), chunk = (5, 32), (3, 16), 16
    idx, meta = _pair_plan(rng, nwd, sd, nws, ss, 300, 1024, chunk)
    nd, ns = nwd * sd, nws * ss
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    arrays = [r(nd, W), r(nd, W), r(ns, W), r(ns, W), r(nd, W),
              r(W), r(W, W), r(W) + 1.0, r(W), r(W, W), r(W) + 1.0, r(W), r(W, W)]
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(meta), chunk=chunk,
                      dst_stride=sd, src_stride=ss)
    ref = jax_win_edge(*map(jnp.asarray, arrays), jplan, True, True, mode="interpret")
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                    dst_stride=sd, src_stride=ss)
    port = win_edge.win_edge_plain(*map(torch.from_numpy, arrays), plan)
    return port, np.asarray(ref), REL, 0.0


FORWARDS = {"lane_layer": _lane_layer, "scenario_agg": _scenario_agg, "pair_agg": _pair_agg,
            "win_edge": _win_edge}


@pytest.mark.parametrize("kernel", list(FORWARDS))
def test_plain_forward_at_64_matches_pallas(kernel):
    port, ref, rel, atol = FORWARDS[kernel]()
    assert tuple(port.shape) == ref.shape and ref.shape[1] == W
    if atol:
        np.testing.assert_allclose(port.numpy(), ref, rtol=rel, atol=atol)
    else:
        _close(port, ref, f"{kernel} at {W}", rel)


# --- the half-width LaneGCN against the JAX LaneGCN ------------------------------

def _seeded_params(shapes):
    """A numpy param tree of the JAX LaneGCN's shapes, from one seed (in
    place of flax's init, whose compile costs more than the forward's):
    kernels N(0, 1/fan_in) with fan_in the product of all but the last
    dimension, GroupNorm weights 1 + N(0, 0.01), other vectors N(0, 0.01)."""
    rng = np.random.RandomState(0)

    def leaf(path, s):
        x = rng.randn(*s.shape).astype(np.float32)
        if len(s.shape) > 1:
            return x / np.sqrt(np.prod(s.shape[:-1]))
        return 0.1 * x + (1.0 if path[-1].key == "weight" else 0.0)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_half_width_lanegcn_eval_matches_jax():
    """The eval forward and loss of LaneGCN at n_map = n_actor = 64 on the
    spill and pair-plan layout, the port's weights the JAX init's."""
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=50 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    g = batch.graph
    assert g.plan_lu is not None and g.spill_pair is not None and batch.fusion.pair_a2m is not None
    assert int((np.asarray(g.spill_pair.idx)[:, 0] >= 0).sum()) > 0
    assert sum(int(e.mask.sum()) for e in g.edges.values()) > 0
    jb = jax.tree.map(jnp.asarray, batch)
    jnet = JLaneGCN(jcfg.model)
    params = _seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jb)["params"])

    @jax.jit
    def forward(p):
        out = jnet.apply({"params": p}, jb)
        return out, jax_pred_loss(out, jb, jcfg.loss)["loss"]

    out, loss = forward(jax.tree.map(jnp.asarray, params))
    cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, params, cfg.model)
    got, m = make_eval_step(cfg, net, device="cpu")(batch)
    for k in ("cls", "reg"):
        _close(got[k], out[k], f"half-width {k}", 1e-4)
    _close(m["loss"], loss, "half-width loss", 1e-4)


# --- the wrappers' width dispatch -----------------------------------------------

def _dispatch(c):
    """{kernel: (its wrapper's check, the CUDA wrapper itself)} on c-wide
    CPU tensors, for every kernel of the port both ways (each takes 64 and
    128). A wrapper refuses at its check, its first statement, before
    anything touches the card."""
    n, j, r_num, num_win, eps = 256, len(SHIFTS), 3, 2, 1e-5
    x, w, v = torch.zeros(n, c), torch.zeros(c, c), torch.zeros(c)
    masks, wb = torch.zeros(j, n, dtype=torch.bool), torch.zeros(j, c, c)
    plan = [torch.zeros(2 * 512, 1, dtype=torch.int32)] * 3
    w_rel = torch.zeros(r_num, c, c)

    def pair_plan(cols):
        return PairPlan(idx=torch.zeros(4, cols, dtype=torch.int32),
                        meta=torch.zeros(6, 1, dtype=torch.int32), chunk=4, dst_stride=4,
                        src_stride=4)

    spill, pair = pair_plan(3), pair_plan(2)
    gns, chain = (v,) * 4, (v, w, v, v, w, v, v, w)  # bd, kdo, gdow, gdob, k1, gchw, gchb, kout
    ll = lambda *kw: lambda: lane_layer._check(x, x, masks, wb, w, gns, SHIFTS, *kw)
    wcs = window_scatter.WCHUNK
    msg, lu = torch.zeros(wcs, c), torch.zeros(wcs, 1, dtype=torch.int32)
    wchunk, d, kd = torch.zeros(1, dtype=torch.int32), torch.zeros(n, 2), torch.zeros(2, c)
    return {
        "lane_layer": (ll(), lambda: lane_layer._fwd_cuda(x, x, masks, wb, w, *gns, SHIFTS,
                                                          eps)),
        "scenario_agg": (lambda: scenario_agg._check(x, x, w_rel, *plan, num_win),
                         lambda: scenario_agg._fwd_cuda(x, x, w_rel, *plan, num_win, None)),
        "pair_agg": (lambda: pair_agg._check(x, x, w_rel, spill),
                     lambda: pair_agg._fwd_cuda(x, x, w_rel, spill)),
        "win_edge": (lambda: win_edge._check(x, x, x, x, x, (w,) * 3, (v,) * 5, pair),
                     lambda: win_edge._fwd_cuda(x, x, x, x, x, *chain, pair, eps)),
        "lane_layer_bwd": (ll("lane_layer_bwd"), lambda: lane_layer.lane_layer_bwd_cuda(
            x, x, masks, wb, w, *gns, x, SHIFTS)),
        "scenario_agg_bwd": (
            lambda: scenario_agg._check(x, x, w_rel, *plan, num_win, "scenario_agg_bwd"),
            lambda: scenario_agg.scenario_agg_bwd_cuda(x, w_rel, *plan, num_win, None, x)),
        "pair_agg_bwd": (lambda: pair_agg._check(x, x, w_rel, spill, "pair_agg_bwd"),
                         lambda: pair_agg.pair_agg_bwd_cuda(x, w_rel, spill, x)),
        "win_edge_bwd": (
            lambda: win_edge._check(x, x, x, x, x, (w,) * 3, (v,) * 5, pair, "win_edge_bwd"),
            lambda: win_edge.win_edge_bwd_cuda(x, x, x, x, *chain, pair, x)),
        "lane_plan": (ll("lane_plan"), lambda: lane_layer._plan_fwd_cuda(
            x, x, masks, wb, w, *gns, w_rel, *plan, num_win, SHIFTS, None, eps)),
        "lane_plan_bwd": (ll("lane_plan_bwd"), lambda: lane_layer.lane_plan_bwd_cuda(
            x, x, masks, wb, w, *gns, w_rel, *plan, num_win, None, x, SHIFTS)),
        "band_conv": (lambda: band_conv._check(x, masks, wb, SHIFTS),
                      lambda: band_conv._fwd_cuda(x, masks, wb, SHIFTS)),
        "band_conv_bwd": (lambda: band_conv._check(x, masks, wb, SHIFTS, "band_conv_bwd"),
                          lambda: band_conv.band_conv_bwd_cuda(x, masks, wb, x, SHIFTS)),
        "window_scatter": (
            lambda: window_scatter._check(msg, x, lu, wchunk, n),
            lambda: window_scatter._fwd_cuda(msg, x, lu, wchunk, n)),
        "window_scatter_bwd": (
            lambda: window_scatter._check_bwd(x, lu, wchunk, n),
            lambda: window_scatter.window_scatter_bwd_cuda(x, lu, wchunk, n)),
        "row_tail2": (lambda: row_tail._check2(x, x, w, w, (v,) * 6),
                      lambda: row_tail._fwd2_cuda(x, x, w, w, *(v,) * 6, eps)),
        "row_tail2_bwd": (lambda: row_tail._check2(x, x, w, w, (v,) * 6, "row_tail2_bwd"),
                          lambda: row_tail.row_tail2_bwd_cuda(x, x, w, w, *(v,) * 6, x)),
        "edge_mlp_pool": (lambda: edge_mlp._pool_prep(d, x, kd, v, w, v, v, w),
                          lambda: edge_mlp._pool_fwd_cuda(d, x, kd, v, w, v, v, w, eps)),
        "edge_mlp_pool_bwd": (
            lambda: edge_mlp._pool_prep(d, x, kd, v, w, v, v, w, x,
                                        name="edge_mlp_pool_bwd"),
            lambda: edge_mlp.edge_mlp_pool_bwd_cuda(d, x, kd, v, w, v, v, w, x)),
    }


@pytest.mark.parametrize("width", [64, 96, 128])
def test_width_dispatch(width):
    """The checks of every kernel (forward and backward) take rows 64 and
    128 wide and their wrappers refuse 96: a ValueError naming the kernel
    and the width, raised by the check before any launch."""
    for name, (check, wrapper) in _dispatch(width).items():
        if width in (64, 128):
            check()
        else:
            with pytest.raises(ValueError, match=rf"^{name}: .*{width}"):
                wrapper()


# --- work() at W = 64 ---------------------------------------------------------------

def test_work_counts_w_squared_products():
    """Each forward's `work()` at W = 64: 2·W² operations per product row
    (lane_layer: the masked band rows plus every row; scenario_agg and
    pair_agg: each applied edge; win_edge: three per valid edge), W-wide
    bytes, and 2·W² per product at 128 scaled by (64/128)²."""
    n, j = 384, len(SHIFTS)
    rng = np.random.RandomState(5)
    masks = torch.from_numpy(rng.rand(j, n) < 0.25)
    for c in (W, 128):
        feat = torch.zeros(n, c, dtype=torch.bfloat16)
        wk = lane_layer.work(feat, masks)
        assert wk["flops"] == 2 * c * c * (int(masks.sum()) + n)
        assert wk["bytes"] == 3 * n * c * 2 + j * n + (j + 1) * c * c * 2 + 4 * c * 4
    nwin, stride, chunk = 5, 64, 16
    rel = np.sort(rng.randint(0, 14, 300)).astype(np.int32)
    idx, meta = _pair_plan(rng, nwin, stride, nwin, stride, 300, 1024, chunk, rel)
    spill = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                     dst_stride=stride, src_stride=stride)
    feat = torch.zeros(nwin * stride, W)
    wp = pair_agg.work(feat, torch.zeros(14, W, W), spill)
    assert wp["edges"] == 300 and wp["flops"] == 2 * 300 * W * W
    assert wp["slot_bytes"] == 2 * 300 * W * 4
    plan, groups, applied = _window_plan(rng)
    ws = scenario_agg.work(torch.zeros(2 * 256, W), *map(torch.from_numpy, plan),
                           torch.zeros(14, W, W), 2, groups)
    assert ws["edges"] == applied and ws["flops"] == 2 * applied * W * W
    assert ws["slot_bytes"] == 2 * applied * W * 4
    pair = PairPlan(idx=torch.from_numpy(idx[:, :2].copy()), meta=torch.from_numpy(meta),
                    chunk=chunk, dst_stride=stride, src_stride=stride)
    we = win_edge.work(feat, feat, pair)
    assert we["edges"] == 300 and we["flops"] == 3 * 2 * 300 * W * W
    assert we["slot_bytes"] == 2 * 300 * W * 4
