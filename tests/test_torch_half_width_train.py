"""The half-width LaneGCN (n_map = n_actor = 64) trains: its backward ops
and its gradients against the JAX package on the CPU.

- The four backwards whose kernels take 64-wide rows (`lane_layer`,
  `scenario_agg`, `pair_agg`, `win_edge`): each public op's gradients on
  CPU tensors (its `torch.autograd.Function`, whose backward is the plain
  backward) at W = 64 against the Pallas VJP (`jax.vjp` in interpret mode,
  as tests/test_torch_grads.py runs them at 128), on the small plans of
  tests/test_torch_half_width.py, float32, every gradient leaf within
  2e-5 · max(1, max |reference leaf|): the tolerance of the 128-wide
  gradient tests (test_torch_grads.py). Both sides sum the same fp32
  products in other orders.
- The half-width LaneGCN's loss and every parameter's gradient of
  pred_loss (one LaneConv layer a stack and one Att a fusion stage, so
  that the JAX compile stays small), with the weights of one
  numpy-seeded JAX param tree carried across by the bridge, against one
  jitted `jax.value_and_grad` on the same JAX-built spill and pair-plan
  pack (tests/test_torch_half_width.py's layout): the loss within rtol
  1e-5 and each leaf within 1e-4 · max |ref leaf| + 1e-9,
  tests/test_torch_train.py's tolerances. A leaf whose reference gradient
  is zero to rounding (max |ref leaf| below 1e-6 of the model's largest
  gradient element) is held to that 1e-6 instead: its terms cancel and
  keep their fp32 reorder noise (pred_net.cls.1.bias, whose gradient is
  zero by construction: the margin loss takes differences of logits that
  share it).
- `work_bwd()` at W = 64: 2·W² operations per product (lane_layer: two on
  the masked band rows, three on every row; scenario_agg and pair_agg: two
  per applied edge; win_edge: nine per valid edge) and W-wide bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig
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
from lanegcn_tpu_torch.ops import lane_layer, pair_agg, scenario_agg, win_edge
from lanegcn_tpu_torch.train.loop import init_state, make_train_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

from test_torch_half_width import (MODEL, PACK, SHIFTS, W, _close, _pair_plan, _seeded_params,
                                   _window_plan)

# One LaneConv layer a stack and one Att a fusion stage: every op of the
# step once, at half the JAX compile of the eval test's two.
TRAIN_MODEL = dict(MODEL, num_fuse_layers=1, num_att_layers=1)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gn(rng, k):
    return [a for _ in range(k) for a in ((1.0 + 0.1 * rng.randn(W)).astype(np.float32),
                                          (0.1 * rng.randn(W)).astype(np.float32))]


# --- the four backwards at W = 64 against the Pallas VJPs -----------------------

def _lane_layer():
    """128 rows (the Pallas kernel's multiple of 128), ±1 .. ±32 band masks."""
    rng = np.random.RandomState(21)
    n, j = 128, len(SHIFTS)
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    arrays = [rng.randn(n, W).astype(np.float32), rng.randn(n, W).astype(np.float32),
              (rng.randn(j, W, W) / np.sqrt(W)).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32), *_gn(rng, 2)]
    jm, tm = jnp.asarray(masks), torch.from_numpy(masks) > 0

    def jfn(feat, pre, wb, w2, *gn):
        return jax_lane_layer(feat, pre, jm, wb, w2, *gn, SHIFTS, 1e-5, True)

    def port(feat, pre, wb, w2, *gn):
        return lane_layer.fused_lane_layer(feat, pre, tm, wb, w2, *gn, SHIFTS)

    names = ["feat", "pre", "wb", "w2", "g1w", "g1b", "g2w", "g2b"]
    return arrays, jfn, port, names, rng.randn(n, W).astype(np.float32)


def _scenario_agg():
    """The grouped window plan of test_torch_half_width.py over 14 relations."""
    rng = np.random.RandomState(22)
    plan, groups, _ = _window_plan(rng)
    n, num_win = 2 * 256, 2
    arrays = [rng.randn(n, W).astype(np.float32), rng.randn(n, W).astype(np.float32),
              (rng.randn(14, W, W) / np.sqrt(W)).astype(np.float32)]
    jplan, tplan = [jnp.asarray(a) for a in plan], [torch.from_numpy(a) for a in plan]

    def jfn(feat, temp, w_rel):
        return jax_scenario_agg(feat, temp, w_rel, *jplan, num_scen=num_win, mode="interpret",
                                groups=groups)

    def port(feat, temp, w_rel):
        return scenario_agg.scenario_aggregate(feat, temp, w_rel, *tplan, num_win, groups)

    return arrays, jfn, port, ["feat", "temp", "w_rel"], rng.randn(n, W).astype(np.float32)


def _pair_agg():
    """A spill plan of 300 edges in 16-slot chunks over five 64-row windows,
    relation-major within a window pair, as the packer's residue."""
    rng = np.random.RandomState(23)
    nwin, stride, chunk = 5, 64, 16
    rel = np.sort(rng.randint(0, 14, 300)).astype(np.int32)
    idx, meta = _pair_plan(rng, nwin, stride, nwin, stride, 300, 1024, chunk, rel)
    n = nwin * stride
    arrays = [(rng.randn(n, W) * 0.2).astype(np.float32),
              (rng.randn(n, W) * 0.2).astype(np.float32),
              (rng.randn(14, W, W) * 0.1).astype(np.float32)]
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(meta), chunk=chunk,
                      dst_stride=stride, src_stride=stride)
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                    dst_stride=stride, src_stride=stride)

    def jfn(feat, temp, w_rel):
        return jax_pair_agg(feat, temp, w_rel, jplan, mode="interpret")

    def port(feat, temp, w_rel):
        return pair_agg.pair_aggregate(feat, temp, w_rel, plan)

    return arrays, jfn, port, ["feat", "temp", "w_rel"], rng.randn(n, W).astype(np.float32)


def _win_edge():
    """An A2M-like pair plan: 300 edges from three 16-row source windows
    into five 32-row destination windows, in 1024 slots of 16-slot chunks."""
    rng = np.random.RandomState(24)
    (nwd, sd), (nws, ss), chunk = (5, 32), (3, 16), 16
    idx, meta = _pair_plan(rng, nwd, sd, nws, ss, 300, 1024, chunk)
    nd, ns = nwd * sd, nws * ss
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    arrays = [r(nd, W), r(nd, W), r(ns, W), r(ns, W), r(nd, W),
              r(W), r(W, W), r(W) + 1.0, r(W), r(W, W), r(W) + 1.0, r(W), r(W, W)]
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(meta), chunk=chunk,
                      dst_stride=sd, src_stride=ss)
    plan = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                    dst_stride=sd, src_stride=ss)

    def jfn(*a):
        return jax_win_edge(*a, jplan, True, True, mode="interpret")

    def port(*a):
        return win_edge.win_edge_mlp(*a, plan)

    names = ["pd", "qd", "ps", "cs", "temp", "bd", "kdo", "gdow", "gdob", "k1", "gchw", "gchb",
             "kout"]
    return arrays, jfn, port, names, rng.randn(nd, W).astype(np.float32)


BACKWARDS = {"lane_layer": _lane_layer, "scenario_agg": _scenario_agg, "pair_agg": _pair_agg,
             "win_edge": _win_edge}


@pytest.mark.parametrize("kernel", list(BACKWARDS))
def test_plain_backward_at_64_matches_pallas_vjp(kernel):
    arrays, jfn, port, names, g = BACKWARDS[kernel]()
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = port(*leaves)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction), out.grad_fn
    assert out.shape[1] == W
    out.backward(torch.from_numpy(g))
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, f"{kernel} d{name}: no gradient"
        _close(leaf.grad, want, f"{kernel} d{name} at {W}")


# --- the half-width LaneGCN's gradients against jax.grad ----------------------------

def test_half_width_lanegcn_grads_match_jax_grad():
    """pred_loss and every parameter's gradient of one float32 train step
    of LaneGCN at n_map = n_actor = 64 on the spill and pair-plan layout
    (every kernel op's backward at W = 64 through its plain version),
    against jax.value_and_grad of the JAX objective with the same weights."""
    jcfg = JConfig(model=JModelConfig(**TRAIN_MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=70 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    g = batch.graph
    assert int((np.asarray(g.spill_pair.idx)[:, 0] >= 0).sum()) > 0
    assert batch.fusion.pair_a2m is not None and g.plan_lu is not None
    jb = jax.tree.map(jnp.asarray, batch)
    jnet = JLaneGCN(jcfg.model)
    params = _seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jb)["params"])

    def objective(p):
        return jax_pred_loss(jnet.apply({"params": p}, jb), jb, jcfg.loss)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(jax.tree.map(jnp.asarray, params))
    ref = export_state_dict(jax.tree.map(np.asarray, jgrads), jcfg.model)

    cfg = Config(model=ModelConfig(**TRAIN_MODEL), pack=PackConfig(**PACK))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, params, cfg.model)
    net, state = init_state(cfg, net=net, device="cpu")
    metrics = make_train_step(cfg, net, state, device="cpu")(batch, 0.0)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(ref)
    # A leaf whose reference gradient is zero to rounding (below 1e-6 of
    # the model's largest element: pred_net.cls.1.bias, which the margin
    # loss sees only through logit differences) has no scale of its own,
    # so it is held to that absolute floor; every other leaf to the
    # relative tolerance.
    zero = 1e-6 * max(float(np.abs(r).max()) for r in ref.values())
    for name, grad in got.items():
        assert grad is not None, f"{name}: no gradient"
        want = ref[name]
        scale = float(np.abs(want).max())
        tol = zero if scale < zero else 1e-4 * scale + 1e-9
        err = float(np.abs(grad.numpy() - want).max())
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
    assert float(metrics["skipped"]) == 0.0


# --- work_bwd() at W = 64 -------------------------------------------------------------

def test_work_bwd_counts_w_squared_products():
    """Each backward's `work_bwd()` at W = 64 and 128: 2·W² operations per
    product (lane_layer: the band transpose and dWb on the masked band rows,
    three on every row; scenario_agg and pair_agg: dfeat and dW_rel per
    applied edge; win_edge: nine per valid edge) and W-wide bytes."""
    rng = np.random.RandomState(25)
    n, j = 384, len(SHIFTS)
    masks = torch.from_numpy(rng.rand(j, n) < 0.25)
    band = int(masks.sum())
    for c in (W, 128):
        wl = lane_layer.work_bwd(torch.zeros(n, c, dtype=torch.bfloat16), masks)
        assert wl["band_rows"] == band
        assert wl["flops"] == 2 * 2 * c * c * band + 3 * 2 * c * c * n
        assert wl["bytes"] == 4 * n * c * 2 + n * c * 4 + j * n + (j + 1) * c * c * 6 + 8 * c * 4

    plan, groups, applied = _window_plan(rng)
    tplan = [torch.from_numpy(a) for a in plan]
    ws = scenario_agg.work_bwd(torch.zeros(2 * 256, W), *tplan, torch.zeros(14, W, W), 2, groups)
    assert ws["edges"] == applied and ws["flops"] == 2 * 2 * applied * W * W
    _, dst_rows, src_rows = scenario_agg._rows_touched(*tplan, 2, 2 * 256, groups, 14)
    assert ws["bytes"] == ((2 * 256 + dst_rows + src_rows) * W * 4 + 3 * plan[0].shape[0] * 4
                           + 14 * W * W * 8)

    nwin, stride, chunk = 5, 64, 16
    rel = np.sort(rng.randint(0, 14, 300)).astype(np.int32)
    idx, meta = _pair_plan(rng, nwin, stride, nwin, stride, 300, 1024, chunk, rel)
    spill = PairPlan(idx=torch.from_numpy(idx), meta=torch.from_numpy(meta), chunk=chunk,
                     dst_stride=stride, src_stride=stride)
    feat = torch.zeros(nwin * stride, W)
    wp = pair_agg.work_bwd(feat, torch.zeros(14, W, W), spill)
    assert wp["edges"] == 300 and wp["flops"] == 2 * 2 * 300 * W * W
    edges, dst_rows, src_rows = pair_agg._edges_and_rows(feat, torch.zeros(14, W, W), spill)
    assert wp["bytes"] == ((nwin * stride + dst_rows + src_rows) * W * 4 + idx.size * 4
                           + meta.size * 4 + 14 * W * W * 8)

    pair = PairPlan(idx=torch.from_numpy(idx[:, :2].copy()), meta=torch.from_numpy(meta),
                    chunk=chunk, dst_stride=stride, src_stride=stride)
    we = win_edge.work_bwd(feat, feat, pair)
    assert we["edges"] == 300 and we["flops"] == 9 * 2 * 300 * W * W
    assert we["slot_bytes"] == 2 * 8 * 300 * W * 4
