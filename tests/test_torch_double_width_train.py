"""The double-width LaneGCN (n_map = n_actor = 256) trains: its backward ops
and its gradients against the JAX package on the CPU.

- The three backwards whose kernels take 256-wide rows (`lane_layer`,
  `row_tail` at K = 1 and Att's `edge_mlp`): each public op's gradients on
  CPU tensors (its `torch.autograd.Function`, whose backward is the plain
  backward) at W = 256 against the Pallas VJP (`jax.vjp` in interpret
  mode, as tests/test_torch_half_width_train.py runs them at 64), float32,
  every gradient leaf within 2e-5 · max(1, max |reference leaf|): the
  tolerance of the 128- and 64-wide gradient tests. Both sides sum the
  same fp32 products in other orders.
- The double-width LaneGCN's loss and every parameter's gradient of
  pred_loss (one LaneConv layer a stack and one Att a fusion stage, so
  that the JAX compile stays small), with the weights of one numpy-seeded
  JAX param tree carried across by the bridge, against one jitted
  `jax.value_and_grad` on the same JAX-built contiguous pack
  (tests/test_torch_double_width.py's layout: neighbour tables and flat
  destination-sorted fusion lists): the loss within rtol 1e-5 and each leaf
  within 1e-4 · max |ref leaf| + 1e-9, the 64-wide test's tolerances, with
  its floor for a leaf whose reference is zero to rounding.
- `work_bwd()` at W = 256: 2·W² operations per product row and W-wide
  bytes, 4x the 128-wide count on the same rows.
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
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_edge_mlp
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer as jax_lane_layer
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail as jax_row_tail

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.ops import edge_mlp, lane_layer, row_tail
from lanegcn_tpu_torch.train.loop import init_state, make_train_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

from test_torch_double_width import MODEL, PACK, W
from test_torch_half_width import SHIFTS, _close, _seeded_params

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


# --- the three backwards at W = 256 against the Pallas VJPs ----------------------

def _lane_layer():
    """256 rows (the Pallas kernel's multiple of 128), ±1 .. ±32 band masks."""
    rng = np.random.RandomState(31)
    n, j = 256, len(SHIFTS)
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


def _row_tail():
    """K = 1 on 300 rows."""
    rng = np.random.RandomState(32)
    n = 300
    arrays = [rng.randn(n, W).astype(np.float32), rng.randn(n, W).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32), *_gn(rng, 2)]

    def jfn(*a):
        return jax_row_tail(*a, mode="interpret")

    names = ["x", "res", "w", "g1w", "g1b", "g2w", "g2b"]
    return arrays, jfn, row_tail.fused_row_tail, names, rng.randn(n, W).astype(np.float32)


def _edge_mlp():
    """Att's flags on 300 rows, the last 50 padding (d = qg = cg = 0, and a
    zero cotangent, as the model's masked scatter gives them)."""
    rng = np.random.RandomState(33)
    e, n_pad = 300, 50
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    d = (rng.randn(e, 2) * 3.0).astype(np.float32)
    qg, cg, g = r(e, W), r(e, W), r(e, W)
    for a in (d, qg, cg, g):
        a[e - n_pad:] = 0.0
    arrays = [d, qg, cg, r(2, W), r(W), r(W, W), r(W) + 1.0, r(W), r(W, W), r(W) + 1.0, r(W),
              r(W, W)]

    def jfn(*a):
        return jax_edge_mlp(*a, True, True, 1e-5, True)

    names = ["d", "qg", "cg", "kd", "bd", "kdo", "gdow", "gdob", "k1", "gchw", "gchb", "kout"]
    return arrays, jfn, edge_mlp.fused_edge_mlp, names, g


BACKWARDS = {"lane_layer": _lane_layer, "row_tail": _row_tail, "edge_mlp": _edge_mlp}


@pytest.mark.parametrize("kernel", list(BACKWARDS))
def test_plain_backward_at_256_matches_pallas_vjp(kernel):
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


# --- the double-width LaneGCN's gradients against jax.grad ----------------------------

def test_double_width_lanegcn_grads_match_jax_grad():
    """pred_loss and every parameter's gradient of one float32 train step
    of LaneGCN at n_map = n_actor = 256 on the contiguous layout (the
    three kernel ops' backwards at W = 256 through their plain versions),
    against jax.value_and_grad of the JAX objective with the same weights."""
    jcfg = JConfig(model=JModelConfig(**TRAIN_MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=60 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    assert batch.graph.plan_lu is None and batch.fusion.pair_a2m is None
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
    assert any(g is not None and g.shape == (W, W) for g in got.values())
    # A leaf whose reference gradient is zero to rounding (below 1e-6 of
    # the model's largest element) has no scale of its own: it is held to
    # that absolute floor, every other leaf to the relative tolerance.
    zero = 1e-6 * max(float(np.abs(r).max()) for r in ref.values())
    for name, grad in got.items():
        assert grad is not None, f"{name}: no gradient"
        want = ref[name]
        scale = float(np.abs(want).max())
        tol = zero if scale < zero else 1e-4 * scale + 1e-9
        err = float(np.abs(grad.numpy() - want).max())
        assert err <= tol, f"{name}: max abs err {err} > {tol}"
    assert float(metrics["skipped"]) == 0.0


# --- work_bwd() at W = 256 ---------------------------------------------------------------

def test_work_bwd_counts_w_squared_products_at_256():
    """Each wide backward's `work_bwd()` at W = 256 and 128 on the same rows:
    2·W² operations per product row (lane_layer: the band transpose and dWb
    on the masked band rows, three on every row; row_tail: three on every
    row; edge_mlp: nine, plus the Wd ones, on the rows whose cotangent is
    non-zero), W-wide bytes, and 4x the 128-wide product count."""
    rng = np.random.RandomState(35)
    n, j = 384, len(SHIFTS)
    masks = torch.from_numpy(rng.rand(j, n) < 0.25)
    band = int(masks.sum())
    wl = {c: lane_layer.work_bwd(torch.zeros(n, c, dtype=torch.bfloat16), masks) for c in (128, W)}
    assert wl[W]["flops"] == 2 * 2 * W * W * band + 3 * 2 * W * W * n == 4 * wl[128]["flops"]
    assert wl[W]["bytes"] == 4 * n * W * 2 + n * W * 4 + j * n + (j + 1) * W * W * 6 + 8 * W * 4
    rt = {c: row_tail.work_bwd(n, 2, c) for c in (128, W)}
    assert rt[W]["flops"] == 3 * 2 * n * W * W == 4 * rt[128]["flops"]
    assert rt[W]["bytes"] == 5 * n * W * 2 + W * W * 6 + 8 * W * 4
    d = torch.from_numpy(rng.randn(n, 2).astype(np.float32))
    g = {c: torch.ones(n, c, dtype=torch.bfloat16) for c in (128, W)}
    g[W][n // 2:] = 0  # rows whose cotangent is zero add no work
    g[128][n // 2:] = 0
    em = {c: edge_mlp.work_bwd(d, g[c], g[c], g[c]) for c in (128, W)}
    assert em[W]["live_rows"] == n // 2
    assert em[W]["flops"] == 2 * (n // 2) * (9 * W * W + 6 * W)
    assert em[W]["flops"] - 4 * em[128]["flops"] == 2 * (n // 2) * (6 * W - 4 * 6 * 128)
    assert em[W]["bytes"] == (n * (16 + 5 * W * 2) + (3 * W * W + 2 * W) * 6 + 10 * W * 4)
