"""The port's LaneRCNN training path against the JAX package's, on the CPU.

Small world, as tests/test_torch_lanercnn.py: 32 channels, 2 LaneConv layers
per stack, 6 modes, 3 scenarios of 2 corridors from numpy seeds, the `flat`
and `windowed` RoI layouts; one JAX init carried into the port by the weight
bridge, one `jax.grad` jit per layout and one jit of the JAX
`make_train_step`. Everything runs in float32: the JAX side through its XLA
formulations (or its Pallas kernels in interpret mode), the port through its
kernels' plain versions.

Tolerances.
- The three new autograd Functions (window_scatter, row_tail2, LanePooling's
  edge MLP): each gradient leaf within 2e-5 · max(1, max |reference leaf|)
  of the Pallas VJP and of torch.autograd of the op's own plain forward, as
  tests/test_torch_grads.py: the same fp32 products summed in other orders.
- LaneRCNN's loss within 1e-5 relative; each parameter's gradient within
  1e-4 of that leaf's max |g|, the scale floored at 1e-4 of the largest
  gradient element (a leaf whose gradient cancels by construction holds
  reorder noise only). The gradients pass through ~20 GroupNorm'd layers
  and Decode's divisions, summed in other orders on the two sides.
- One AdamW step: Adam moves each element by about lr·sign(g), so where a
  gradient element lies at the reorder noise the two sides may step apart
  (at most 2·lr); at most 1e-3 of the elements may differ by more than
  1e-6, and none by more than 2·lr.
- remat=True against remat=False: the same loss and gradients bitwise (the
  same ops on the same inputs, recomputed).
- roi_loss_for_goals and the standalone heads: within 1e-5 relative.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, LossConfig as JLossConfig
from lanegcn_tpu.config import ModelConfig as JModelConfig, RoiPackConfig as JRoiPackConfig
from lanegcn_tpu.config import TrainConfig as JTrainConfig
from lanegcn_tpu.data.lane_roi import generate_lane_rois as jax_generate_lane_rois
from lanegcn_tpu.data.packing_roi import pack_roi_batch as jax_pack_roi_batch
from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_scenario
from lanegcn_tpu.models.lanercnn import LaneRCNN as JLaneRCNN
from lanegcn_tpu.models.lanercnn import PredHead as JPredHead, RefineHead as JRefineHead
from lanegcn_tpu.models.lanercnn import roi_loss as jax_roi_loss, roi_metrics as jax_roi_metrics
from lanegcn_tpu.models.lanercnn import roi_loss_for_goals as jax_roi_loss_for_goals
from lanegcn_tpu.models import registry as jax_registry
from lanegcn_tpu.models.registry import get_model as jax_get_model
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_fused_edge_mlp
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail2 as jax_fused_row_tail2
from lanegcn_tpu.ops.pallas_window_scatter import window_scatter_add as jax_window_scatter
from lanegcn_tpu.train.loop import make_train_step as jax_make_train_step
from lanegcn_tpu.train.optimizer import coef_tree, make_optimizer as jax_make_optimizer

from lanegcn_tpu_torch.config import Config, ModelConfig, RoiPackConfig, TrainConfig
from lanegcn_tpu_torch.data.packing import window_chunked_edges
from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
from lanegcn_tpu_torch.data.synthetic import make_roi_scenario
from lanegcn_tpu_torch.graph import RoiPackedBatch
from lanegcn_tpu_torch.models import lanercnn
from lanegcn_tpu_torch.models.lanercnn import LaneRCNN, PredHead, RefineHead
from lanegcn_tpu_torch.models.lanercnn import roi_loss, roi_loss_for_goals, roi_metrics
from lanegcn_tpu_torch.models import registry
from lanegcn_tpu_torch.models.registry import available, get_model
from lanegcn_tpu_torch.ops import edge_mlp, row_tail, window_scatter
from lanegcn_tpu_torch.train.loop import init_state, make_train_step, train_epochs
from lanegcn_tpu_torch.train.optimizer import flax_paths, make_optimizer
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2)
_COMMON = dict(max_scenarios=3, max_rois=36, max_interest_nodes=512, max_edges_scale0=1024,
               max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=1024,
               max_pool_edges=16384, max_a2r_edges=2048)
LAYOUTS = {
    "flat": dict(_COMMON, max_roi_nodes=2048, max_global_nodes=1536),
    "windowed": dict(_COMMON, max_roi_nodes=2048, node_stride=256, max_plan_edges=512,
                     max_global_nodes=1536, global_node_stride=256, global_plan_edges=1024,
                     table_relations=()),
}
SEEDS = (40, 41, 42)
C = 128
OP_REL = 2e-5
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-4
PARAM_FAR, PARAM_FAR_SHARE = 1e-6, 1e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, what, rel):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


# --- the three new autograd Functions ---------------------------------------

def _port_grads(op, leaves, rest, g):
    out = op(*leaves, *rest)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction), out.grad_fn
    out.backward(_t(g))
    return [t.grad for t in leaves]


def _autograd_plain(plain, leaves, rest, g):
    fresh = [t.detach().clone().requires_grad_(True) for t in leaves]
    plain(*fresh, *rest).backward(_t(g))
    return [t.grad for t in fresh]


def _leaves(arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]


def _check_op_grads(name, names, grads, ref, auto):
    for nm, got, want in zip(names, grads, ref):
        _close(got, want, f"{name} d{nm}", OP_REL)
    for nm, got, want in zip(names, grads, auto):
        _close(got, want.numpy(), f"{name} d{nm} vs autograd", OP_REL)


def _ws_case(case, rng):
    """Window-chunked edges over 4 windows: random, all padding, or one
    window whose tail chunks repeat its id."""
    stride, nwin, c = 128, 4, C
    n_edges = {"random": 900, "all_padding": 0, "tail_chunks": 150}[case]
    u = rng.randint(0, (1 if case == "tail_chunks" else nwin) * stride, n_edges)
    cap = 4 * window_scatter.WCHUNK
    es, dropped = window_chunked_edges(u, rng.randint(0, 50, n_edges), cap, stride, 50)
    assert dropped == 0
    if case == "tail_chunks":
        assert (es.win_chunk[1:] == es.win_chunk[0]).all() and es.win_first.sum() == 1
    msg = rng.randn(cap, c).astype(np.float32)
    temp = rng.randn(nwin * stride, c).astype(np.float32)
    g = rng.randn(nwin * stride, c).astype(np.float32)
    return msg, temp, es.win_lu, es.win_chunk, es.win_first, stride, g


@pytest.mark.parametrize("case", ["random", "all_padding", "tail_chunks"])
def test_window_scatter_grads_match_pallas_vjp(case):
    """d_msg (g at each edge's destination, zero on padding) and d_temp = g."""
    msg, temp, lu, wc, first, stride, g = _ws_case(case, np.random.RandomState(21))
    jplan = tuple(map(jnp.asarray, (lu, wc, first)))
    _, vjp = jax.vjp(lambda m, t: jax_window_scatter(m, t, *jplan, stride, mode="interpret"),
                     jnp.asarray(msg), jnp.asarray(temp))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves([msg, temp])
    rest = (_t(lu), _t(wc), stride)
    grads = _port_grads(window_scatter.window_scatter_add, leaves, rest, g)
    auto = _autograd_plain(window_scatter.window_scatter_plain, leaves, rest, g)
    _check_op_grads("window_scatter", ["msg", "temp"], grads, ref, auto)
    assert torch.equal(grads[1], _t(g))
    pad = _t(lu)[:, 0] < 0
    assert not grads[0][pad].any()


@pytest.mark.parametrize("n", [300, 1024], ids=["ragged-rows", "tile-rows"])
def test_row_tail2_grads_match_pallas_vjp(n):
    rng = np.random.RandomState(22)
    arrays = [rng.randn(n, C).astype(np.float32), (0.5 * rng.randn(n, C)).astype(np.float32),
              *((rng.randn(C, C) / np.sqrt(C)).astype(np.float32) for _ in range(2)),
              *(a for _ in range(3) for a in ((1.0 + 0.1 * rng.randn(C)).astype(np.float32),
                                              (0.1 * rng.randn(C)).astype(np.float32)))]
    g = rng.randn(n, C).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_fused_row_tail2(*a, mode="interpret"),
                     *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))
    leaves = _leaves(arrays)
    grads = _port_grads(row_tail.fused_row_tail2, leaves, (), g)
    auto = _autograd_plain(row_tail.row_tail2_plain, leaves, (), g)
    _check_op_grads("row_tail2", ["x", "res", "w1", "w2", "g1w", "g1b", "g2w", "g2b", "g3w",
                                  "g3b"], grads, ref, auto)


@pytest.mark.parametrize("e", [700, 1024], ids=["ragged-with-padding", "tile-rows"])
def test_edge_mlp_pool_grads_match_pallas_vjp(e):
    """LanePooling's flags (no dist_out stage, no query, d [E, 4]); with
    e = 700 (not a multiple of 512) the last 100 rows are padding (d = cg
    = 0) and carry a cotangent too."""
    rng = np.random.RandomState(23)
    d = (3 * rng.randn(e, 4)).astype(np.float32)
    cg = rng.randn(e, C).astype(np.float32)
    if e == 700:
        d[600:], cg[600:] = 0, 0
    arrays = [d, cg, (rng.randn(4, C) / 2).astype(np.float32),
              (0.1 * rng.randn(C)).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32),
              (1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)]
    g = rng.randn(e, C).astype(np.float32)
    kdo, gdo1, gdo0 = jnp.zeros((C, C)), jnp.ones(C), jnp.zeros(C)

    def jfn(d, cg, kd, bd, k1, gw, gb, kout):
        return jax_fused_edge_mlp(d, None, cg, kd, bd, kdo, gdo1, gdo0, k1, gw, gb, kout,
                                  False, False, 1e-5, True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))

    def op(d, cg, kd, bd, k1, gw, gb, kout):
        return edge_mlp.fused_edge_mlp(d, None, cg, kd, bd, None, None, None, k1, gw, gb, kout,
                                       False, False)

    def plain(d, cg, kd, bd, k1, gw, gb, kout):
        return edge_mlp.edge_mlp_plain(d, None, cg, kd, bd, None, None, None, k1, gw, gb, kout,
                                       False, False)

    leaves = _leaves(arrays)
    grads = _port_grads(op, leaves, (), g)
    _check_op_grads("edge_mlp_pool", ["d", "cg", "kd", "bd", "k1", "gchw", "gchb", "kout"],
                    grads, ref, _autograd_plain(plain, leaves, (), g))


# --- LaneRCNN: loss, gradients, the AdamW step, remat --------------------------

@pytest.fixture(scope="module")
def world():
    """Built on first use, once per file: each layout's two packs and one
    JAX init."""
    return {}


def _layout(w, layout):
    if layout not in w:
        if "scens" not in w:
            w["jscens"] = [jax_generate_lane_rois(jax_make_scenario(seed=s, num_corridors=2,
                                                                    num_actors=6))
                           for s in SEEDS]
            w["scens"] = [make_roi_scenario(seed=s, num_corridors=2, num_actors=6) for s in SEEDS]
        jcfg = JConfig(model=JModelConfig(**MODEL), roi_pack=JRoiPackConfig(**LAYOUTS[layout]))
        cfg = Config(model=ModelConfig(**MODEL), roi_pack=RoiPackConfig(**LAYOUTS[layout]))
        jb, _ = jax_pack_roi_batch(copy.deepcopy(w["jscens"]), jcfg.roi_pack, jcfg.model)
        pb, stats = pack_roi_batch(copy.deepcopy(w["scens"]), cfg.roi_pack, cfg.model)
        assert not any(v for k, v in stats.items() if "dropped" in k), stats
        jbatch = jax.tree.map(jnp.asarray, jb)
        if "params" not in w:
            w["jnet"] = JLaneRCNN(jcfg.model)
            w["params"] = jax.jit(w["jnet"].init)(jax.random.PRNGKey(0), jbatch)["params"]
            w["params_np"] = jax.tree.map(np.asarray, w["params"])
        w[layout] = dict(jcfg=jcfg, cfg=cfg, jb=jbatch, pb=RoiPackedBatch.from_numpy(pb))
    return w[layout]


def _port_net(w, remat=False):
    net = LaneRCNN(ModelConfig(**MODEL), device="cpu", remat=remat)
    load_jax_params(net, w["params_np"], net.cfg, "lanercnn")
    return net


def _port_grads_of_loss(net, batch):
    net.zero_grad(set_to_none=True)
    out = net(batch)
    loss = roi_loss(out, batch, Config().loss)["loss"]
    loss.backward()
    return loss, {n: p.grad for n, p in net.named_parameters()}


def _check_model_grads(got, ref, what):
    assert set(got) == set(ref)
    top = max(float(np.abs(v).max()) for v in ref.values())
    for name, g in got.items():
        assert g is not None, f"{what} {name}: no gradient"
        want = ref[name]
        tol = GRAD_REL * max(float(np.abs(want).max()), GRAD_FLOOR * top)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol, f"{what} {name}: max abs err {err} > {tol}"


@pytest.mark.parametrize("layout", ["flat", "windowed"])
def test_lanercnn_grads_match_jax_grad(world, layout):
    """roi_loss and every parameter's gradient against jax.grad of the JAX
    roi_loss, the gradients mapped through the weight bridge's transposes."""
    w = _layout(world, layout)
    jnet, jb = world["jnet"], w["jb"]

    def objective(p):
        return jax_roi_loss(jnet.apply({"params": p}, jb), jb, w["jcfg"].loss)["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(objective))(world["params"])
    ref = export_state_dict(jax.tree.map(np.asarray, jgrads), w["jcfg"].model, "lanercnn")
    loss, got = _port_grads_of_loss(_port_net(world), w["pb"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _check_model_grads(got, ref, layout)


def test_adamw_step_matches_jax_train_step(world):
    """One port step, make_train_step(loss_fn=roi_loss, metrics_fn=roi_metrics)
    with the registry's AdamW (wd 0.01), against the JAX make_train_step with
    the JAX registry's: the loss, the metrics and the parameters after it."""
    w = _layout(world, "windowed")
    jbundle = jax_get_model("lanercnn", JConfig(model=JModelConfig(**MODEL)))
    assert jbundle.config.train.opt == "adamw"
    tx, lr_fn = jax_make_optimizer(jbundle.config.train)
    jstep = jax_make_train_step(jbundle.config, world["jnet"], tx, lr_fn,
                                loss_fn=jax_roi_loss, metrics_fn=jax_roi_metrics)
    jparams, _, jm = jstep(world["params"], tx.init(world["params"]), w["jb"], 0.0)
    ref = export_state_dict(jax.tree.map(np.asarray, jparams), w["jcfg"].model, "lanercnn")

    bundle = get_model("lanercnn", Config(model=ModelConfig(**MODEL)), device="cpu")
    assert (bundle.config.train.opt, bundle.config.train.weight_decay) == ("adamw", 0.01)
    load_jax_params(bundle.net, world["params_np"], bundle.net.cfg, "lanercnn")
    start = {n: p.detach().clone() for n, p in bundle.net.named_parameters()}
    net, state = init_state(bundle.config, net=bundle.net, device="cpu")
    m = make_train_step(bundle.config, net, state, device="cpu", loss_fn=bundle.loss_fn,
                        metrics_fn=bundle.metrics_fn)(w["pb"], 0.0)
    assert set(m) == set(jm) and float(m["skipped"]) == 0.0
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    lr = float(m["lr"])
    far = moved = total = 0
    for name, p in net.named_parameters():
        diff = np.abs(p.detach().numpy() - ref[name])
        assert float(diff.max()) <= 2 * lr, (name, float(diff.max()))
        far += int((diff > PARAM_FAR).sum())
        moved += int((p.detach() != start[name]).sum())
        total += diff.size
    assert far <= PARAM_FAR_SHARE * total, f"{far} of {total} params apart by > {PARAM_FAR}"
    assert moved > 0.9 * total, f"the step moved only {moved} of {total} params"


def test_remat_gives_the_same_loss_and_grads(world, monkeypatch):
    """remat=True (each LanePooling under activation checkpointing) against
    remat=False from the same weights on the windowed pack: the same loss
    and gradients, bitwise; the recompute runs each pooling's ops again,
    the kernels' included."""
    w = _layout(world, "windowed")
    loss, grads = _port_grads_of_loss(_port_net(world), w["pb"])
    calls = {}
    for name in ("fused_edge_mlp", "window_scatter_add", "fused_row_tail2"):
        fn = getattr(lanercnn, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)

        monkeypatch.setattr(lanercnn, name, counted)
    loss_r, grads_r = _port_grads_of_loss(_port_net(world, remat=True), w["pb"])
    assert calls == {"fused_edge_mlp": 6, "window_scatter_add": 4, "fused_row_tail2": 6}, calls
    assert torch.equal(loss, loss_r)
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def test_train_epochs_takes_the_roi_loss(world):
    """train_epochs passes loss_fn and metrics_fn to every step: two steps on
    the flat pack with finite ADE/FDE."""
    w = _layout(world, "flat")
    cfg = Config(model=ModelConfig(**MODEL), train=TrainConfig(opt="adamw"))
    net, state = init_state(cfg, net=_port_net(world), device="cpu")
    state, summary = train_epochs(cfg, net, state, [w["pb"]] * 2, num_steps=2,
                                  steps_per_epoch=10, log_fn=lambda s: None, device="cpu",
                                  loss_fn=roi_loss, metrics_fn=roi_metrics)
    assert state.step == 2 and int(state.opt.count) == 2
    assert all(np.isfinite(summary[k]) for k in ("loss", "ade", "fde")), summary


def test_flax_paths_and_lr_coef_match_jax_coef_tree(world):
    """flax_paths reads LaneRCNN's weight table; lr_coef rules give each
    port parameter the coefficient the JAX coef_tree gives its leaf
    (matched through the weight bridge, stacked relation kernels split)."""
    _layout(world, "flat")
    net = _port_net(world)
    paths = flax_paths(net)
    assert set(paths) == {n for n, _ in net.named_parameters()}
    assert paths["interactor.roi2graph.ctx.0.linear.weight"] == \
        "interactor/roi2graph/ctx_hidden/linear/kernel"
    rules = (("roi_net1/fuse", 0.5), ("interactor/roi2graph", 2.0), ("decode/lane_pool", 0.25),
             ("interactor", 3.0))
    opt, _ = make_optimizer(TrainConfig(lr_coef=rules), net)
    coefs = jax.tree.map(lambda c, p: np.full(p.shape, c, np.float32),
                         coef_tree(world["params_np"], rules), world["params_np"])
    ref = export_state_dict(coefs, net.cfg, "lanercnn")
    off = 0
    for name, p in zip(opt.names, opt.params):
        got = opt.coef[off:off + p.numel()].view(p.shape).numpy()
        off += p.numel()
        np.testing.assert_array_equal(got, ref[name], err_msg=name)
    assert set(opt.coef.unique().tolist()) == {0.25, 0.5, 1.0, 2.0, 3.0}


# --- the rest of the module ------------------------------------------------------

def test_roi_loss_for_goals_matches_jax(world):
    """The goal-only loss on seeded random outputs against the windowed
    pack's ground truth, every field (goals_to_eval included)."""
    w = _layout(world, "windowed")
    rng = np.random.RandomState(25)
    b = w["pb"].scen_mask.shape[0]
    out = {"pred_logics": rng.randn(b, 6), "pred_goals": 20 * rng.randn(b, 6, 2),
           "pred_trajs": 20 * rng.randn(b, 6, 30, 2)}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    want = jax_roi_loss_for_goals({k: jnp.asarray(v) for k, v in out.items()}, w["jb"],
                                  JLossConfig())
    got = roi_loss_for_goals({k: _t(v) for k, v in out.items()}, w["pb"], Config().loss)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], f"roi_loss_for_goals {k}", 1e-5)
    full = roi_loss({k: _t(v) for k, v in out.items()}, w["pb"], Config().loss)
    assert torch.equal(got["cls_loss"], full["cls_loss"])
    assert torch.equal(got["reg_loss"], full["reg_goal_loss"])


@pytest.mark.parametrize("head", ["pred", "refine"])
def test_standalone_heads_match_jax(head):
    """PredHead / RefineHead against the JAX modules, weights through their
    weight tables (`pred_head`, `refine_head`)."""
    jcfg, cfg = JModelConfig(**MODEL), ModelConfig(**MODEL)
    feat = np.random.RandomState(26).randn(17, MODEL["n_map"]).astype(np.float32)
    jmod, mod = (JPredHead(jcfg), PredHead(cfg)) if head == "pred" else \
        (JRefineHead(jcfg), RefineHead(cfg))
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(feat))["params"]
    load_jax_params(mod, jax.tree.map(np.asarray, params), cfg, f"{head}_head")
    with torch.no_grad():
        got = mod(_t(feat))
    want = jmod.apply({"params": params}, jnp.asarray(feat))
    assert tuple(got.shape) == ((17, 5) if head == "pred" else (17, 6, 30, 2))
    _close(got, want, head, 1e-5)


def test_get_model_promotes_adam_to_adamw():
    """The registry: both families, LaneRCNN's adam → adamw with wd 0.01 (as
    the JAX registry) unless a decay is set, the net on the asked device."""
    assert available() == ["lanegcn", "lanercnn"]
    cfg = Config(model=ModelConfig(**MODEL))
    b = get_model("lanercnn", cfg, device="cpu", seed=3)
    jb = jax_get_model("lanercnn", JConfig(model=JModelConfig(**MODEL)))
    assert (b.config.train.opt, b.config.train.weight_decay) == \
        (jb.config.train.opt, jb.config.train.weight_decay) == ("adamw", 0.01)
    assert isinstance(b.net, LaneRCNN) and b.loss_fn is roi_loss and b.metrics_fn is roi_metrics
    assert next(b.net.parameters()).device.type == "cpu"
    kept = get_model("lanercnn", Config(train=TrainConfig(weight_decay=0.1)), device="cpu")
    assert (kept.config.train.opt, kept.config.train.weight_decay) == ("adam", 0.1)
    g = get_model("lanegcn", cfg, device="cpu")
    assert g.config is cfg and g.config.train.opt == "adam"
    with pytest.raises(KeyError):
        get_model("nope")
    assert JTrainConfig().opt == TrainConfig().opt == "adam"


@pytest.mark.parametrize("family", ["lanegcn", "lanercnn"])
def test_extract_fns_match_jax(family):
    """Each family's extract_fn (predictions, ground truth and mode
    probabilities of the valid scenarios, as numpy) against the JAX
    registry's on the same seeded outputs; a padding scenario is dropped."""
    rng = np.random.RandomState(27)
    b, a = 4, 9
    arrays = dict(scen_mask=np.array([True, True, False, True]),
                  agent_idx=np.array([0, 3, 0, 6]),
                  gt_preds=rng.randn(a if family == "lanegcn" else b, 30, 2).astype(np.float32))
    rows = a if family == "lanegcn" else b
    out = ({"cls": rng.randn(rows, 6), "reg": rng.randn(rows, 6, 30, 2)} if family == "lanegcn"
           else {"pred_logics": rng.randn(rows, 6), "pred_trajs": rng.randn(rows, 6, 30, 2)})
    out = {k: v.astype(np.float32) for k, v in out.items()}
    jfn = getattr(jax_registry, f"_extract_{family}")
    want = jfn(out, types.SimpleNamespace(**arrays))
    got = getattr(registry, f"_extract_{family}")(
        {k: _t(v) for k, v in out.items()},
        types.SimpleNamespace(**{k: _t(v) for k, v in arrays.items()}))
    assert get_model(family, device="cpu").extract_fn is getattr(registry, f"_extract_{family}")
    for g, x in zip(got, want):
        assert g.shape == x.shape and g.shape[0] == 3
        np.testing.assert_allclose(g, x, rtol=1e-6)
