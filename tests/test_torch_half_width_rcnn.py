"""The half-width LaneRCNN (n_map = n_actor = 64) against the JAX package
on the CPU: LanePooling's three ops at W = 64, the model's loss and
gradients, and the ops' work counts.

- `window_scatter`, `row_tail2` and LanePooling's `edge_mlp` at W = 64:
  each public op's forward on CPU tensors (the plain version) against the
  Pallas kernel in interpret mode, and its gradients (its
  `torch.autograd.Function`, whose backward is the plain backward) against
  the Pallas VJP (`jax.vjp`), float32, every output and gradient leaf
  within 2e-5 · max(1, max |reference|): tests/test_torch_lanercnn_train.py's
  tolerance at 32 and 128 (the same fp32 products summed in other orders).
- A half-width LaneRCNN with one LaneConv layer a stack, on one JAX-built
  windowed RoI pack (r2g and g2r window-chunked, so both pool scatters run
  `window_scatter`), with the weights of one numpy-seeded JAX param tree
  carried across by the bridge (strict): roi_loss within rtol 1e-5 and each
  parameter's gradient within 1e-4 of that leaf's max |g|, the scale
  floored at 1e-4 of the largest gradient element, against one jitted
  `jax.value_and_grad` (test_torch_lanercnn_train.py's tolerances).
- `work2`, `work2_bwd`, `work` and `work_pool_bwd` at W = 64: W-wide bytes
  and 2·W² operations per product row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import RoiPackConfig as JRoiPackConfig
from lanegcn_tpu.data.lane_roi import generate_lane_rois as jax_generate_lane_rois
from lanegcn_tpu.data.packing_roi import pack_roi_batch as jax_pack_roi_batch
from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_scenario
from lanegcn_tpu.models.lanercnn import LaneRCNN as JLaneRCNN, roi_loss as jax_roi_loss
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_fused_edge_mlp
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail2 as jax_fused_row_tail2
from lanegcn_tpu.ops.pallas_window_scatter import window_scatter_add as jax_window_scatter

from lanegcn_tpu_torch.config import Config, ModelConfig
from lanegcn_tpu_torch.data.packing import window_chunked_edges
from lanegcn_tpu_torch.graph import RoiPackedBatch
from lanegcn_tpu_torch.models.lanercnn import LaneRCNN, roi_loss
from lanegcn_tpu_torch.ops import edge_mlp, row_tail, window_scatter
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

from test_torch_half_width import _seeded_params

W = 64
MODEL = dict(n_actor=W, n_map=W, num_fuse_layers=1)
ROI_PACK = dict(max_scenarios=3, max_rois=36, max_interest_nodes=512, max_edges_scale0=1024,
                max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=1024,
                max_pool_edges=16384, max_a2r_edges=2048, max_roi_nodes=2048, node_stride=256,
                max_plan_edges=512, max_global_nodes=1536, global_node_stride=256,
                global_plan_edges=1024, table_relations=())
SEEDS = (40, 41, 42)
OP_REL = 2e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, what, rel=OP_REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _forward_and_vjp(name, names, op, jop, arrays, g, rest=()):
    """The op's forward and gradients (leaves `arrays`) against the JAX
    op's forward and VJP at the cotangent g."""
    out, vjp = jax.vjp(jop, *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]
    got = op(*leaves, *rest)
    assert isinstance(got.grad_fn, torch.autograd.function.BackwardCFunction), got.grad_fn
    assert tuple(got.shape[1:]) == (W,)
    _close(got, out, f"{name} forward")
    got.backward(_t(g))
    for nm, leaf, want in zip(names, leaves, ref):
        _close(leaf.grad, want, f"{name} d{nm}")
    return leaves


# --- the three ops at W = 64 against the Pallas kernels ---------------------------

@pytest.mark.parametrize("case", ["random", "tail_chunks"])
def test_window_scatter_at_64_matches_pallas(case):
    """out = temp + the messages at their rows; d_msg = g at each edge's
    destination (zero on padding), d_temp = g. tail_chunks: one window
    whose tail chunks repeat its id."""
    rng = np.random.RandomState(31)
    stride, nwin = 128, 4
    n_edges = {"random": 900, "tail_chunks": 150}[case]
    u = rng.randint(0, (1 if case == "tail_chunks" else nwin) * stride, n_edges)
    cap = 4 * window_scatter.WCHUNK
    es, dropped = window_chunked_edges(u, rng.randint(0, 50, n_edges), cap, stride, 50)
    assert dropped == 0
    msg = rng.randn(cap, W).astype(np.float32)
    temp = rng.randn(nwin * stride, W).astype(np.float32)
    g = rng.randn(nwin * stride, W).astype(np.float32)
    jplan = tuple(map(jnp.asarray, (es.win_lu, es.win_chunk, es.win_first)))
    leaves = _forward_and_vjp(
        "window_scatter", ["msg", "temp"], window_scatter.window_scatter_add,
        lambda m, t: jax_window_scatter(m, t, *jplan, stride, mode="interpret"), [msg, temp], g,
        rest=(_t(es.win_lu), _t(es.win_chunk), stride))
    assert torch.equal(leaves[1].grad, _t(g))
    assert not leaves[0].grad[_t(es.win_lu)[:, 0] < 0].any()


def test_row_tail2_at_64_matches_pallas():
    """relu(GN3(relu(GN2(relu(GN1(x)) @ W1)) @ W2) + res) and its ten
    gradients, on 300 rows (no multiple of the kernels' 64-row tiles)."""
    rng = np.random.RandomState(32)
    n = 300
    arrays = [rng.randn(n, W).astype(np.float32), (0.5 * rng.randn(n, W)).astype(np.float32),
              *((rng.randn(W, W) / np.sqrt(W)).astype(np.float32) for _ in range(2)),
              *(a for _ in range(3) for a in ((1.0 + 0.1 * rng.randn(W)).astype(np.float32),
                                              (0.1 * rng.randn(W)).astype(np.float32)))]
    g = rng.randn(n, W).astype(np.float32)
    _forward_and_vjp("row_tail2", ["x", "res", "w1", "w2", "g1w", "g1b", "g2w", "g2b", "g3w",
                                   "g3b"], row_tail.fused_row_tail2,
                     lambda *a: jax_fused_row_tail2(*a, mode="interpret"), arrays, g)


def test_edge_mlp_pool_at_64_matches_pallas():
    """LanePooling's flags (no dist_out stage, no query, d [E, 4]) on 700
    rows whose last 100 are padding (d = cg = 0) and carry a cotangent."""
    rng = np.random.RandomState(33)
    e = 700
    d = (3 * rng.randn(e, 4)).astype(np.float32)
    cg = rng.randn(e, W).astype(np.float32)
    d[600:], cg[600:] = 0, 0
    arrays = [d, cg, (rng.randn(4, W) / 2).astype(np.float32),
              (0.1 * rng.randn(W)).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32),
              (1 + 0.1 * rng.randn(W)).astype(np.float32), (0.1 * rng.randn(W)).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32)]
    g = rng.randn(e, W).astype(np.float32)
    kdo, gdo1, gdo0 = jnp.zeros((W, W)), jnp.ones(W), jnp.zeros(W)

    def jop(d, cg, kd, bd, k1, gw, gb, kout):
        return jax_fused_edge_mlp(d, None, cg, kd, bd, kdo, gdo1, gdo0, k1, gw, gb, kout,
                                  False, False, 1e-5, True)

    def op(d, cg, kd, bd, k1, gw, gb, kout):
        return edge_mlp.fused_edge_mlp(d, None, cg, kd, bd, None, None, None, k1, gw, gb, kout,
                                       False, False)

    _forward_and_vjp("edge_mlp_pool", ["d", "cg", "kd", "bd", "k1", "gchw", "gchb", "kout"],
                     op, jop, arrays, g)


# --- the half-width LaneRCNN against jax.value_and_grad ---------------------------

def test_half_width_lanercnn_grads_match_jax():
    """roi_loss and every parameter's gradient of LaneRCNN at n_map =
    n_actor = 64 on one JAX-built windowed RoI pack, the port's weights the
    JAX tree's through the bridge, against one jitted jax.value_and_grad."""
    jcfg = JConfig(model=JModelConfig(**MODEL), roi_pack=JRoiPackConfig(**ROI_PACK))
    scens = [jax_generate_lane_rois(jax_make_scenario(seed=s, num_corridors=2, num_actors=6))
             for s in SEEDS]
    jb, stats = jax_pack_roi_batch(scens, jcfg.roi_pack, jcfg.model)
    assert not any(v for k, v in stats.items() if "dropped" in k), stats
    batch = RoiPackedBatch.from_numpy(jb)
    assert batch.r2g.win_lu is not None and batch.g2r.win_lu is not None
    jbatch = jax.tree.map(jnp.asarray, jb)
    jnet = JLaneRCNN(jcfg.model)
    params = _seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jbatch)["params"])

    def objective(p):
        return jax_roi_loss(jnet.apply({"params": p}, jbatch), jbatch, jcfg.loss)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(params)
    ref = export_state_dict(jax.tree.map(np.asarray, jgrads), jcfg.model, "lanercnn")

    net = LaneRCNN(ModelConfig(**MODEL), device="cpu")
    load_jax_params(net, params, net.cfg, "lanercnn")
    pools = [m for m in net.modules() if type(m).__name__ == "LanePooling"]
    assert len(pools) == 3 and all(p.n == W for p in pools)
    out = net(batch)
    loss = roi_loss(out, batch, Config().loss)["loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = {n: p.grad for n, p in net.named_parameters()}
    assert set(got) == set(ref)
    top = max(float(np.abs(v).max()) for v in ref.values())
    for name, g in got.items():
        assert g is not None, f"{name}: no gradient"
        tol = GRAD_REL * max(float(np.abs(ref[name]).max()), GRAD_FLOOR * top)
        err = float(np.abs(g.numpy() - ref[name]).max())
        assert err <= tol, f"{name}: max abs err {err} > {tol}"


# --- work() at W = 64 ---------------------------------------------------------------

def test_pool_work_counts_at_64():
    """row_tail2 and LanePooling's edge_mlp count W-wide bytes and 2·W²
    operations per product row at 64, and a quarter of the 128-wide
    products."""
    n, db = 1000, 2
    for c in (W, 128):
        assert row_tail.work2(n, db, c) == {
            "bytes": 3 * n * c * db + 2 * c * c * db + 6 * c * 4, "flops": 2 * 2 * n * c * c}
        assert row_tail.work2_bwd(n, db, c) == {
            "bytes": 5 * n * c * db + 2 * c * c * (db + 4) + 12 * c * 4,
            "flops": 6 * 2 * n * c * c}
    assert row_tail.work2(n, db, W)["flops"] * 4 == row_tail.work2(n, db)["flops"]
    e, din = 700, 4
    d = torch.ones(e, din)
    d[600:] = 0
    cg = torch.zeros(e, W, dtype=torch.bfloat16)
    fw = edge_mlp.work(d, None, cg, has_dist2=False)
    assert fw["live_rows"] == 601  # 600 rows and the padding's shared one
    assert fw["flops"] == 2 * 601 * (din * W + 2 * W * W)
    assert fw["bytes"] == e * (din * 4 + 2 * W * 2) + (2 * W * W + din * W) * 2 + 3 * W * 4
    g = torch.zeros(e, W, dtype=torch.bfloat16)
    g[:500] = 1
    bw = edge_mlp.work_pool_bwd(d, cg, g)
    assert bw["live_rows"] == 500
    assert bw["flops"] == 2 * 500 * (5 * W * W + 3 * din * W)
    assert bw["bytes"] == (e * (2 * din * 4 + 3 * W * 2) + (2 * W * W + din * W) * (2 + 4)
                           + 6 * W * 4)
