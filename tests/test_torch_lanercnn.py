"""The port's LaneRCNN eval path against the JAX package's, on the CPU.

Inputs are seeded: the same synthetic scenarios (each package's own
generator and RoI builder, from the same seeds), random rows from numpy.
One JAX init (32 channels, 2 LaneConv layers per stack, 6 modes) is carried
into the port by the weight bridge (a strict load). Both sides run float32:
the JAX side through its XLA formulations or its Pallas kernels in
interpret mode, the port through its kernels' plain versions.

Two tiny RoI layouts: `flat` (contiguous nodes, left/right tables, flat
destination-sorted pool edges: LanePooling's `scatter_add` branch) and
`windowed` (256-row RoI and global windows, window plans, window-chunked
pool edges: the `window_scatter` branch), both 3 scenarios of 2 corridors.

Tolerances. Packs: equal, array for array. Kernels' plain versions and
modules: within 1e-5 (kernels) or 1e-4 (modules, the eval step) relative
to max(1, max |reference|), as tests/test_torch_model.py: both sides sum
the same fp32 products in other orders. pred_trajs is held to the same
1e-4 of its largest element: Decode divides by 2 + adx - cos(theta) and
takes arctan of a ratio of network outputs, which can grow a reorder error
by a few orders near a zero denominator; here the largest error measures
~2e-5 of 56 m. NMS picks are compared exactly (through pred_goals).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import RoiPackConfig as JRoiPackConfig
from lanegcn_tpu.data.lane_roi import generate_lane_rois as jax_generate_lane_rois
from lanegcn_tpu.data.packing import window_chunked_edges as jax_window_chunked_edges
from lanegcn_tpu.data.packing_roi import pack_roi_batch as jax_pack_roi_batch
from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_scenario
from lanegcn_tpu.models.lanercnn import Decode as JDecode, LanePooling as JLanePooling
from lanegcn_tpu.models.lanercnn import LaneRCNN as JLaneRCNN
from lanegcn_tpu.models.lanercnn import roi_loss as jax_roi_loss, roi_metrics as jax_roi_metrics
from lanegcn_tpu.models.lanercnn import segmented_nms as jax_segmented_nms
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_fused_edge_mlp
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail2 as jax_fused_row_tail2
from lanegcn_tpu.ops.pallas_row_tail import xla_reference2
from lanegcn_tpu.ops.pallas_window_scatter import window_scatter_add as jax_window_scatter
from lanegcn_tpu.ops.pallas_window_scatter import xla_reference as ws_xla_reference

from lanegcn_tpu_torch.config import Config, ModelConfig, RoiPackConfig, lanercnn_pack_config
from lanegcn_tpu_torch.data.packing import window_chunked_edges
from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
from lanegcn_tpu_torch.data.synthetic import make_roi_scenario
from lanegcn_tpu_torch.graph import RoiPackedBatch
from lanegcn_tpu_torch.models.lanercnn import LaneRCNN, roi_loss, roi_metrics, segmented_nms
from lanegcn_tpu_torch.ops.edge_mlp import edge_mlp_plain, fused_edge_mlp
from lanegcn_tpu_torch.ops.row_tail import fused_row_tail2, row_tail2_plain
from lanegcn_tpu_torch.ops.window_scatter import WCHUNK, window_scatter_add, window_scatter_plain
from lanegcn_tpu_torch.train.loop import make_eval_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, lanercnn_table, load_jax_params

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2)
_COMMON = dict(max_scenarios=3, max_rois=36, max_interest_nodes=512, max_edges_scale0=1024,
               max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=1024,
               max_pool_edges=16384, max_a2r_edges=2048)
LAYOUTS = {
    "flat": dict(_COMMON, max_roi_nodes=2048, max_global_nodes=1536),
    # The global plan has 1024 slots per window (relation-grouped in the
    # LaneConv stack), the RoI plan 512 (ungrouped).
    "windowed": dict(_COMMON, max_roi_nodes=2048, node_stride=256, max_plan_edges=512,
                     max_global_nodes=1536, global_node_stride=256, global_plan_edges=1024,
                     table_relations=()),
}
SEEDS = (40, 41, 42)
REL = 1e-4


def _close(port, ref, what, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max())) if ref.size else 0.0
    err = float(np.abs(port - ref).max()) if port.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def world():
    """Built on first use, once per file: each layout's two packs (JAX's and
    the port's), one JAX init, and per layout the JAX eval step's outputs
    and metrics (one jit)."""
    return {}


def _scenarios(w):
    if "scens" not in w:
        w["jscens"] = [jax_generate_lane_rois(jax_make_scenario(seed=s, num_corridors=2,
                                                                num_actors=6)) for s in SEEDS]
        w["scens"] = [make_roi_scenario(seed=s, num_corridors=2, num_actors=6) for s in SEEDS]
    return w["jscens"], w["scens"]


def _layout(w, layout):
    if layout not in w:
        jscens, scens = _scenarios(w)
        jcfg = JConfig(model=JModelConfig(**MODEL), roi_pack=JRoiPackConfig(**LAYOUTS[layout]))
        cfg = Config(model=ModelConfig(**MODEL), roi_pack=RoiPackConfig(**LAYOUTS[layout]))
        jb, jstats = jax_pack_roi_batch(copy.deepcopy(jscens), jcfg.roi_pack, jcfg.model)
        pb, stats = pack_roi_batch(copy.deepcopy(scens), cfg.roi_pack, cfg.model)
        assert jstats["packed_scenarios"] == len(SEEDS)
        assert not any(v for k, v in stats.items() if "dropped" in k), stats
        jbatch = jax.tree.map(jnp.asarray, jb)
        if "params" not in w:
            w["jnet"] = JLaneRCNN(jcfg.model)
            w["params"] = jax.jit(w["jnet"].init)(jax.random.PRNGKey(0), jbatch)["params"]
            w["params_np"] = jax.tree.map(np.asarray, w["params"])
        jnet = w["jnet"]

        @jax.jit
        def ev(p, b):
            out = jnet.apply({"params": p}, b)
            m = dict(jax_roi_loss(out, b, jcfg.loss))
            m.update(jax_roi_metrics(out, b))
            return out, m

        jout, jm = ev(w["params"], jbatch)
        w[layout] = dict(cfg=cfg, jb=jb, jstats=jstats, pb=pb, stats=stats,
                         out={k: np.asarray(v) for k, v in jout.items()},
                         metrics={k: float(v) for k, v in jm.items()})
    return w[layout]


def _port_net(w):
    if "net" not in w:
        cfg = Config(model=ModelConfig(**MODEL))
        net = LaneRCNN(cfg.model, device="cpu")
        load_jax_params(net, w["params_np"], cfg.model, "lanercnn")
        w["net"] = net
    return w["net"]


def _leaves(x, prefix=""):
    """{path: numpy array or int} of a pack (either package's)."""
    if x is None:
        return {prefix: None}
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(_leaves(x[k], f"{prefix}.{k}"))
        return out
    if hasattr(x, "__dataclass_fields__"):
        out = {}
        for f in x.__dataclass_fields__:
            out.update(_leaves(getattr(x, f), f"{prefix}.{f}"))
        return out
    if isinstance(x, (int, np.integer)):
        return {prefix: int(x)}
    return {prefix: np.asarray(x)}


@pytest.mark.parametrize("layout", ["flat", "windowed"])
def test_pack_roi_batch_matches_jax(world, layout):
    """The port's RoI generator and packer give the JAX package's pack, array
    for array (dtypes included), and the same stats."""
    w = _layout(world, layout)
    want, got = _leaves(w["jb"]), _leaves(w["pb"])
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        if v is None or isinstance(v, int):
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert w["stats"] == w["jstats"]
    b = w["pb"]
    if layout == "windowed":
        assert b.r2g.win_lu is not None and b.g2r.win_lu is not None and b.a2r.win_lu is None
        assert b.plan_lu is not None and b.graph.plan_lu is not None and not b.tables
    else:
        assert b.r2g.win_lu is None and b.r2g.inv_perm is not None and b.tables


@pytest.mark.parametrize("case", ["random", "empty", "overflow"])
def test_window_chunked_edges_matches_jax(case):
    """Every field, on random edges over 4 windows, on no edges (the
    all-padding plan) and past the capacity (later windows drop)."""
    rng = np.random.RandomState(3)
    stride, nwin = 128, 4
    if case == "random":
        u, v, cap = rng.randint(0, nwin * stride, 900), rng.randint(0, 333, 900), 4 * WCHUNK
    elif case == "empty":
        u, v, cap = np.zeros(0, np.int64), np.zeros(0, np.int64), 2 * WCHUNK
    else:
        u = np.concatenate([np.full(700, k * stride) for k in range(nwin)])
        v, cap = np.arange(len(u)) % 50, 2 * WCHUNK
    es, dropped = window_chunked_edges(u, v, cap, stride, 333)
    jes, jdropped = jax_window_chunked_edges(u, v, cap, stride, 333)
    assert dropped == jdropped
    assert _leaves(es).keys() == _leaves(jes).keys()
    for k, x in _leaves(jes).items():
        y = _leaves(es)[k]
        assert (y == x) if isinstance(x, int) else np.array_equal(y, x), k


def _ws_case(case, rng):
    """(msg, temp, lu, wchunk, first, stride) as numpy (the JAX kernel reads
    `first`, the port's does not): random edges over 4
    windows; the all-padding plan (first[0] = 1, window 0 keeps temp); or a
    plan whose tail chunks repeat the last window id."""
    stride, nwin, c = 128, 4, 32
    n_edges = {"random": 900, "all_padding": 0, "tail_chunks": 150}[case]
    u = rng.randint(0, (1 if case == "tail_chunks" else nwin) * stride, n_edges)
    cap = 4 * WCHUNK
    es, dropped = window_chunked_edges(u, rng.randint(0, 50, n_edges), cap, stride, 50)
    assert dropped == 0
    if case == "tail_chunks":
        assert (es.win_chunk[1:] == es.win_chunk[0]).all() and es.win_first.sum() == 1
    if case == "all_padding":
        assert es.win_first[0] == 1 and (es.win_lu == -1).all()
    msg = rng.randn(cap, c).astype(np.float32)
    temp = rng.randn(nwin * stride, c).astype(np.float32)
    return msg, temp, es.win_lu, es.win_chunk, es.win_first, stride


@pytest.mark.parametrize("case", ["random", "all_padding", "tail_chunks"])
def test_window_scatter_plain_matches_jax(case):
    """The plain version against the JAX Pallas kernel in interpret mode and
    against its XLA reference (1e-5 relative)."""
    msg, temp, lu, wc, first, stride = _ws_case(case, np.random.RandomState(7))
    got = window_scatter_add(_t(msg), _t(temp), _t(lu), _t(wc), stride)
    assert torch.equal(got, window_scatter_plain(_t(msg), _t(temp), _t(lu), _t(wc), stride))
    jargs = tuple(map(jnp.asarray, (msg, temp, lu, wc, first)))
    _close(got, jax_window_scatter(*jargs, stride, mode="interpret"), f"{case} interpret",
           1e-5)
    _close(got, ws_xla_reference(*jargs, stride), f"{case} xla", 1e-5)
    if case == "all_padding":
        assert torch.equal(got, _t(temp))


def _rt2_args(rng, n=300, c=128):
    x = rng.randn(n, c).astype(np.float32)
    res = (0.5 * rng.randn(n, c)).astype(np.float32)
    w1, w2 = (rng.randn(c, c).astype(np.float32) / np.sqrt(c) for _ in range(2))
    affs = [(1.0 + 0.1 * rng.randn(c) if i % 2 == 0 else 0.1 * rng.randn(c)).astype(np.float32)
            for i in range(6)]
    return (x, res, w1, w2, *affs)


def test_row_tail2_plain_matches_jax():
    """The K = 2 tail's plain version against JAX `fused_row_tail2` in
    interpret mode and its unfused XLA reference (1e-5 relative)."""
    args = _rt2_args(np.random.RandomState(11))
    got = fused_row_tail2(*map(_t, args))
    assert torch.equal(got, row_tail2_plain(*map(_t, args)))
    jargs = tuple(map(jnp.asarray, args))
    _close(got, jax_fused_row_tail2(*jargs, mode="interpret"), "row_tail2 interpret", 1e-5)
    _close(got, xla_reference2(*jargs), "row_tail2 xla", 1e-5)


def test_edge_mlp_pool_plain_matches_jax():
    """LanePooling's edge chain (d [E, 4], no dist_out stage, no query),
    plain version against JAX `fused_edge_mlp(..., False, False,
    interpret=True)`; padding rows (d = cg = 0) included (1e-5 relative)."""
    rng = np.random.RandomState(12)
    e, c = 700, 128
    d = (3 * rng.randn(e, 4)).astype(np.float32)
    cg = rng.randn(e, c).astype(np.float32)
    d[600:], cg[600:] = 0, 0
    kd = (rng.randn(4, c) / 2).astype(np.float32)
    bd = (0.1 * rng.randn(c)).astype(np.float32)
    k1, kout = (rng.randn(c, c).astype(np.float32) / np.sqrt(c) for _ in range(2))
    gw = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    gb = (0.1 * rng.randn(c)).astype(np.float32)
    got = fused_edge_mlp(_t(d), None, _t(cg), _t(kd), _t(bd), None, None, None, _t(k1),
                         _t(gw), _t(gb), _t(kout), False, False)
    assert torch.equal(got, edge_mlp_plain(_t(d), None, _t(cg), _t(kd), _t(bd), None, None,
                                           None, _t(k1), _t(gw), _t(gb), _t(kout), False,
                                           False))
    want = jax_fused_edge_mlp(
        jnp.asarray(d), None, jnp.asarray(cg), jnp.asarray(kd), jnp.asarray(bd),
        jnp.zeros((c, c)), jnp.ones(c), jnp.zeros(c), jnp.asarray(k1), jnp.asarray(gw),
        jnp.asarray(gb), jnp.asarray(kout), False, False, 1e-5, True)
    _close(got, want, "edge_mlp pool", 1e-5)
    with pytest.raises(NotImplementedError):
        fused_edge_mlp(_t(d), _t(cg), _t(cg), _t(kd), _t(bd), None, None, None, _t(k1),
                       _t(gw), _t(gb), _t(kout), False, True)


@pytest.mark.parametrize("stage", ["roi2graph", "graph2roi"])
def test_lane_pooling_matches_jax(world, stage):
    """One LanePooling on the windowed pack's window-chunked pool edges
    (the window_scatter branch), from seeded random features."""
    w = _layout(world, "windowed")
    net = _port_net(world)
    jb, pb = w["jb"], RoiPackedBatch.from_numpy(w["pb"])
    rng = np.random.RandomState(13)
    c = MODEL["n_map"]
    roi = rng.randn(jb.node_feats.shape[0], c).astype(np.float32)
    glob = rng.randn(jb.graph.ctrs.shape[0], c).astype(np.float32)
    roi_pose = jb.node_feats[:, :4]
    g_pose = np.concatenate([jb.graph.ctrs, jb.graph.feats], -1)
    args, edges = {"roi2graph": ((roi, roi_pose, glob, g_pose), "r2g"),
                   "graph2roi": ((glob, g_pose, roi, roi_pose), "g2r")}[stage]
    want = JLanePooling(c).apply({"params": world["params"]["interactor"][stage]},
                                 *map(jnp.asarray, args),
                                 jax.tree.map(jnp.asarray, getattr(jb, edges)))
    with torch.no_grad():
        got = getattr(net.interactor, stage)(*map(_t, args), getattr(pb, edges))
    _close(got, want, stage)


@pytest.mark.parametrize("case", ["greedy", "segments", "random"])
def test_segmented_nms_matches_jax(case):
    """The JAX package's test_segmented_nms_* cases, and a random one with
    an empty segment and padding nodes, pick for pick."""
    if case == "greedy":
        xy = np.array([[0.0, 0], [1.0, 0], [3.0, 0], [3.5, 0], [10.0, 0]], np.float32)
        logits = np.array([5.0, 4.0, 3.0, 2.0, 1.0], np.float32)
        seg, mask, nseg, k = np.zeros(5, np.int32), np.ones(5, bool), 1, 5
    elif case == "segments":
        xy = np.array([[0.0, 0], [0.5, 0], [0.0, 0], [0.5, 0]], np.float32)
        logits = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
        seg, mask, nseg, k = np.array([0, 0, 1, 1], np.int32), np.ones(4, bool), 2, 2
    else:
        rng = np.random.RandomState(14)
        xy = (4 * rng.randn(60, 2)).astype(np.float32)
        logits = rng.randn(60).astype(np.float32)
        seg = rng.choice([0, 1, 3], 60).astype(np.int32)  # segment 2 is empty
        mask, nseg, k = rng.rand(60) < 0.8, 4, 6
    want = np.asarray(jax_segmented_nms(*map(jnp.asarray, (xy, logits, seg, mask)), nseg, k))
    got = segmented_nms(*map(_t, (xy, logits, seg, mask)), nseg, k)
    assert got.tolist() == want.tolist()
    if case == "greedy":
        assert got[0].tolist() == [0, 2, 4, 1, 3]


def test_decode_matches_jax(world):
    """Decode on the windowed pack from seeded random RoI features: the
    NMS picks (through pred_goals), the goal logits and the refined
    trajectories."""
    w = _layout(world, "windowed")
    net = _port_net(world)
    jb = w["jb"]
    roi = np.random.RandomState(15).randn(jb.node_feats.shape[0], MODEL["n_map"])
    roi = roi.astype(np.float32)
    jcfg = JModelConfig(**MODEL)
    want = JDecode(jcfg).apply({"params": world["params"]["decode"]}, jnp.asarray(roi),
                               jax.tree.map(jnp.asarray, jb))
    with torch.no_grad():
        got = net.decode(_t(roi), RoiPackedBatch.from_numpy(w["pb"]))
    for name, g, x in zip(("logits", "goals", "trajs"), got, want):
        _close(g, x, f"decode {name}")


@pytest.mark.parametrize("layout", ["flat", "windowed"])
def test_eval_step_matches_jax(world, layout):
    """make_eval_step(loss_fn=roi_loss, metrics_fn=roi_metrics) at fp32 on
    the CPU against the JAX eval step, weights through the bridge; the
    step takes the JAX package's numpy pack as well as the port's."""
    w = _layout(world, layout)
    net = _port_net(world)
    step = make_eval_step(w["cfg"], net, device="cpu", loss_fn=roi_loss, metrics_fn=roi_metrics)
    out, m = step(w["pb"])
    for k, ref in w["out"].items():
        _close(out[k], ref, f"{layout} {k}")
    assert set(m) == set(w["metrics"])
    for k, ref in w["metrics"].items():
        _close(m[k], ref, f"{layout} {k}")
    out2, _ = step(w["jb"])
    assert all(torch.equal(out[k], out2[k]) for k in out)


def test_weight_bridge_is_strict_and_round_trips(world):
    """Every entry of the LaneRCNN table names one port parameter and the
    port has no other; the state_dict comes back as the JAX params."""
    _layout(world, "windowed")
    net = _port_net(world)
    cfg = ModelConfig(**MODEL)
    names = [t for t, _, _, _ in lanercnn_table(cfg)]
    assert len(names) == len(set(names)) and set(names) == set(net.state_dict())
    sd = export_state_dict(world["params_np"], cfg, "lanercnn")
    assert all(np.array_equal(net.state_dict()[k].numpy(), v) for k, v in sd.items())


def test_full_width_pack_config_serves():
    """lanercnn_pack_config(2) packs 2 urban scenarios with zero drops of any
    kind (the global graph's residue lists included) and the full-width
    model (128 channels, 4 LaneConv layers per stack) serves it with finite
    outputs of the expected shapes."""
    cfg = Config(roi_pack=lanercnn_pack_config(2))
    scens = [make_roi_scenario(seed=s, num_corridors=7, num_actors=12, urban=True)
             for s in range(2)]
    batch, stats = pack_roi_batch(scens, cfg.roi_pack, cfg.model)
    assert stats["packed_scenarios"] == 2
    assert not any(v for k, v in stats.items() if k.startswith(("dropped", "graph_dropped",
                                                                 "skipped"))), stats
    assert batch.r2g.win_lu is not None and batch.g2r.win_lu is not None
    net = LaneRCNN(cfg.model, device="cpu", seed=0)
    out, m = make_eval_step(cfg, net, device="cpu", loss_fn=roi_loss,
                            metrics_fn=roi_metrics)(batch)
    assert out["pred_trajs"].shape == (2, 6, 30, 2) and out["pred_logics"].shape == (2, 6)
    assert all(torch.isfinite(v).all() for v in out.values())
    assert all(np.isfinite(float(v)) for v in m.values())
