"""The half-width LaneGCN (n_map = n_actor = 64) in its two other layer
settings, merged (`merge_plan_agg="auto"`: the window plan inside the
layer, `lane_plan`) and unfused (`pallas_bands="off"`: `band_conv` then the
row tail), against the JAX package on the CPU.

- `band_conv` and `lane_plan` at W = 64, their plain versions (the
  forwards, and the backwards through each public op's
  `torch.autograd.Function`) against the Pallas kernels in interpret mode
  (`jax.vjp`, whose primal output is the forward), float32, on two windows
  of 256 rows, at the tolerances of the 128-wide files they mirror:
  `band_conv` within 1e-5 of the reference's RMS
  (tests/test_torch_band_conv.py), `lane_plan` within 1e-5 of the
  largest element of each output and gradient leaf
  (tests/test_torch_plan_layer.py). Both sides sum the same fp32 products
  in other orders.
- The half-width LaneGCN, merged and unfused, with the weights of one
  numpy-seeded JAX param tree on the shapes of the JAX init
  (`jax.eval_shape`) carried across by the bridge, against the JAX LaneGCN
  with the same settings on the same JAX-built pack: the eval forward and
  the loss within 1e-4 of max(1, max |reference|)
  (tests/test_torch_half_width.py). The merged model also every
  parameter's gradient against `jax.value_and_grad` (one jit for its
  forward, loss and gradients), at tests/test_torch_half_width_train.py's
  tolerances: the loss within rtol 1e-5, each leaf within
  1e-4 · max |ref leaf| + 1e-9, a leaf whose reference is zero to rounding
  held to 1e-6 of the model's largest gradient element.
  The port merges the plan into the layer only where the window stride is
  a multiple of 128 and at least 512 and the plan's slots per window a
  multiple of 512 (models/map_net.py `merge_plan`), so the merged model
  runs on 512-row windows with a 512-slot plan; the test counts its layer
  calls: every LaneConv layer takes `fused_lane_layer_plan`, none the
  separate layer. The unfused model runs on test_torch_half_width.py's
  spill and pair-plan layout, every LaneConv layer through `band_conv`.
- `work()` and `work_bwd()` of both ops at W = 64: 2·W² operations per
  masked band row (and, for `lane_plan`, per applied plan edge) and W-wide
  bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.ops.pallas_band_conv import band_conv as jax_band_conv
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer_plan as jax_lane_plan

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig
from lanegcn_tpu_torch.models import map_net
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.ops import band_conv, lane_layer
from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

from test_torch_half_width import MODEL, PACK, SHIFTS, W, _close, _seeded_params, _window_plan

NUM_WIN, STRIDE = 2, 256
# Two LaneConv layers a stack (the second takes the first's output) and one
# Att a fusion stage, so that the JAX compiles stay small.
HALF = dict(MODEL, num_att_layers=1)
# 512-row node windows and a 512-slot plan: the smallest pack the port's
# merge gate takes (map_net.merge_plan); the spill and fusion pair plans as
# in PACK.
MERGED_PACK = dict(PACK, max_nodes=512 * 3, node_stride=512, max_plan_edges=512)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_close(port, ref, what):
    """Within 1e-5 of the reference's largest element."""
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


# --- the two ops at W = 64 against the Pallas kernels ---------------------------------

def test_band_conv_at_64_matches_jax_kernel():
    """band_conv's output and its autograd gradients (dfeat, dW) on two
    256-row windows against the Pallas kernel's jax.vjp in interpret
    mode, each within 1e-5 of the reference's RMS; the output is the
    plain version's."""
    rng = np.random.RandomState(41)
    n, j = NUM_WIN * STRIDE, len(SHIFTS)
    feat = rng.randn(n, W).astype(np.float32)
    masks = rng.rand(j, n) < 0.6
    for k, s in enumerate(SHIFTS):  # jnp.roll wraps where the port reads zeros
        if s > 0:
            masks[k, n - s:] = False
        else:
            masks[k, :-s] = False
    w = (rng.randn(j, W, W) / np.sqrt(W)).astype(np.float32)
    g = rng.randn(n, W).astype(np.float32)
    jm = jnp.asarray(masks, jnp.float32)
    out, vjp = jax.vjp(lambda f, ww: jax_band_conv(f, jm, ww, SHIFTS, True), jnp.asarray(feat),
                       jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))

    tf, tw = torch.from_numpy(feat).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tm = torch.from_numpy(masks)
    got = band_conv.band_conv(tf, tm, tw, SHIFTS)
    assert isinstance(got.grad_fn, torch.autograd.function.BackwardCFunction), got.grad_fn
    got.backward(torch.from_numpy(g))
    assert torch.equal(got, band_conv.band_conv_plain(tf.detach(), tm, tw.detach(), SHIFTS))
    for name, port, ref in (("out", got, out), ("dfeat", tf.grad, dx), ("dW", tw.grad, dw)):
        port, ref = port.detach().numpy(), np.asarray(ref)
        assert port.shape == ref.shape and ref.shape[-1] == W, (name, port.shape, ref.shape)
        rms = float(np.sqrt((ref ** 2).mean()))
        err = float(np.abs(port - ref).max())
        assert err <= 1e-5 * rms, f"band_conv {name} at {W}: max abs err {err} > 1e-5 · {rms}"


def test_lane_plan_at_64_matches_jax_kernel():
    """fused_lane_layer_plan's output and its autograd gradients (feat,
    pre, wb, w2, the four GN vectors, w_rel) on the grouped plan of two
    256-row windows against the Pallas kernel's jax.vjp in interpret mode,
    each within 1e-5 of the reference's largest element; the output is the
    plain version's."""
    rng = np.random.RandomState(42)
    plan, groups, applied = _window_plan(rng)
    assert applied > 0
    n, j = NUM_WIN * STRIDE, len(SHIFTS)
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    gn = [a for _ in range(2) for a in ((1.0 + 0.1 * rng.randn(W)).astype(np.float32),
                                        (0.1 * rng.randn(W)).astype(np.float32))]
    arrays = [rng.randn(n, W).astype(np.float32), rng.randn(n, W).astype(np.float32),
              (rng.randn(j, W, W) / np.sqrt(W)).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32), *gn,
              (rng.randn(14, W, W) / np.sqrt(W)).astype(np.float32)]
    g = rng.randn(n, W).astype(np.float32)
    jm, jplan = jnp.asarray(masks), [jnp.asarray(a) for a in plan]

    def jfn(feat, pre, wb, w2, g1w, g1b, g2w, g2b, w_rel):
        return jax_lane_plan(feat, pre, jm, wb, w2, g1w, g1b, g2w, g2b, w_rel, *jplan, NUM_WIN,
                             SHIFTS, groups, 1e-5, True)

    out, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref = vjp(jnp.asarray(g))

    tm, tplan = torch.from_numpy(masks) > 0, [torch.from_numpy(a) for a in plan]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = lane_layer.fused_lane_layer_plan(leaves[0], leaves[1], tm, *leaves[2:], *tplan,
                                           NUM_WIN, SHIFTS, groups)
    assert isinstance(got.grad_fn, torch.autograd.function.BackwardCFunction), got.grad_fn
    got.backward(torch.from_numpy(g))
    detached = [t.detach() for t in leaves]
    assert torch.equal(got, lane_layer.lane_plan_plain(detached[0], detached[1], tm,
                                                       *detached[2:], *tplan, NUM_WIN, SHIFTS,
                                                       groups))
    _rel_close(got, out, f"lane_plan out at {W}")
    names = ["feat", "pre", "wb", "w2", "g1w", "g1b", "g2w", "g2b", "w_rel"]
    for name, leaf, want in zip(names, leaves, ref):
        assert leaf.grad is not None, f"lane_plan d{name}: no gradient"
        _rel_close(leaf.grad, want, f"lane_plan d{name} at {W}")


# --- the half-width LaneGCN, merged and unfused, against the JAX LaneGCN ----------------

def _world(pack, fields, seeds):
    """The JAX config with the model's layer `fields`, a JAX-built pack of
    three urban scenarios (zero drops) and one numpy-seeded param tree."""
    jcfg = JConfig(model=JModelConfig(**HALF, **fields), pack=JPackConfig(**pack))
    scens = [jax_make_urban(seed=s, num_corridors=3, num_actors=8) for s in seeds]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    assert batch.graph.plan_lu is not None and stats.get("plan_edges", 0) > 0, stats
    jb = jax.tree.map(jnp.asarray, batch)
    jnet = JLaneGCN(jcfg.model)
    params = _seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jb)["params"])
    return jcfg, jb, jnet, batch, params


def _port(pack, fields, params):
    cfg = Config(model=ModelConfig(**HALF, **fields), pack=PackConfig(**pack))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, params, cfg.model)
    return cfg, net


def _counting(monkeypatch, names):
    """Counts of the calls map_net makes to each op in `names`."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(map_net, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(map_net, name, wrapped)
    return calls


def test_half_width_merged_lanegcn_matches_jax(monkeypatch):
    """merge_plan_agg="auto" on 512-row windows with a 512-slot plan: the
    eval forward and loss, then one train step's loss and every
    parameter's gradient, against one jitted jax.value_and_grad of the JAX
    LaneGCN with the same setting; every LaneConv layer of both runs took
    the plan-merged layer."""
    fields = dict(merge_plan_agg="auto")
    # On one CPU, scenario seeds 80-82 put one ReLU input of the merged port
    # at -3e-8 where the separate order gives +1.5e-7: a tie between two
    # correct orders (the test below), which carries M2M's gradients past
    # the tolerance. Seeds 90-92 hold no such tie. On the CPU, JAX runs its
    # separate XLA formulation here: its merged Pallas layer needs
    # pallas_bands="on" or "interpret".
    jcfg, jb, jnet, batch, params = _world(MERGED_PACK, fields, range(90, 93))
    num_win = batch.graph.plan_lu.shape[0] // MERGED_PACK["max_plan_edges"]
    assert map_net.merge_plan(ModelConfig(**fields), MERGED_PACK["max_nodes"],
                              batch.graph.plan_lu.shape[0], num_win)

    def objective(p):
        out = jnet.apply({"params": p}, jb)
        return jax_pred_loss(out, jb, jcfg.loss)["loss"], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ref = export_state_dict(jax.tree.map(np.asarray, jgrads), jcfg.model)

    calls = _counting(monkeypatch, ("fused_lane_layer_plan", "fused_lane_layer", "band_conv"))
    cfg, net = _port(MERGED_PACK, fields, params)
    got, m = make_eval_step(cfg, net, device="cpu")(batch)
    for k in ("cls", "reg"):
        _close(got[k], jout[k], f"merged half-width {k}", 1e-4)
    _close(m["loss"], jloss, "merged half-width loss", 1e-4)

    net, state = init_state(cfg, net=net, device="cpu")
    metrics = make_train_step(cfg, net, state, device="cpu")(batch, 0.0)
    layers = 2 * HALF["num_fuse_layers"]  # MapNet's and M2M's, in each of the two runs
    assert calls == {"fused_lane_layer_plan": 2 * layers, "fused_lane_layer": 0,
                     "band_conv": 0}, calls
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    assert float(metrics["skipped"]) == 0.0
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(ref)
    zero = 1e-6 * max(float(np.abs(r).max()) for r in ref.values())
    for name, grad in got.items():
        assert grad is not None, f"{name}: no gradient"
        want = ref[name]
        scale = float(np.abs(want).max())
        tol = zero if scale < zero else 1e-4 * scale + 1e-9
        err = float(np.abs(grad.numpy() - want).max())
        assert err <= tol, f"{name}: max abs err {err} > {tol}"


class _ReluInputs(TorchFunctionMode):
    """Every torch.relu input of a run, flattened, in call order."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.relu, torch.nn.functional.relu):
            self.calls.append(args[0].detach().reshape(-1).float().clone())
        return func(*args, **(kwargs or {}))


def test_half_width_merged_and_separate_differ_by_rounding_at_seeds_80_82():
    """Scenario seeds 80-82, which the merged test above leaves for 90-92:
    one train step of the merged half-width port (lane_plan_plain: the
    band sum, then each plan message added in turn, as the card's
    add_runs_tc adds them) and one of the separate port (scenario_agg's
    messages into temp, then the band products), same weights and pack.
    Every ReLU input agrees to 1e-5 of its call's RMS, a sign differs only
    where both values lie within that of zero (a tie of two correct
    orders, which moves the gradients through the ReLU's mask), and the
    losses agree within rtol 1e-5."""
    fields = dict(merge_plan_agg="auto")
    _, _, _, batch, params = _world(MERGED_PACK, fields, range(80, 83))
    runs = {}
    for setting in ("auto", "off"):
        cfg, net = _port(MERGED_PACK, dict(merge_plan_agg=setting), params)
        net, state = init_state(cfg, net=net, device="cpu")
        rec = _ReluInputs()
        with rec:
            m = make_train_step(cfg, net, state, device="cpu")(batch, 0.0)
        runs[setting] = (float(m["loss"]), rec.calls)
    (merged_loss, merged), (separate_loss, separate) = runs["auto"], runs["off"]
    np.testing.assert_allclose(merged_loss, separate_loss, rtol=1e-5)
    assert len(merged) == len(separate) > 0
    for k, (a, b) in enumerate(zip(merged, separate)):
        tol = 1e-5 * float(b.square().mean().sqrt())
        assert float((a - b).abs().max()) <= tol, f"relu call {k}: {float((a - b).abs().max())}"
        flip = (a > 0) != (b > 0)
        assert bool((a[flip].abs() <= tol).all() and (b[flip].abs() <= tol).all()), k


def test_half_width_unfused_lanegcn_matches_jax(monkeypatch):
    """pallas_bands="off" on the spill and pair-plan layout: the eval
    forward and loss against the JAX LaneGCN with the same setting; every
    LaneConv layer ran band_conv, none the fused layer."""
    fields = dict(pallas_bands="off")
    jcfg, jb, jnet, batch, params = _world(PACK, fields, range(50, 53))

    @jax.jit
    def forward(p):
        out = jnet.apply({"params": p}, jb)
        return out, jax_pred_loss(out, jb, jcfg.loss)["loss"]

    out, loss = forward(jax.tree.map(jnp.asarray, params))
    calls = _counting(monkeypatch, ("fused_lane_layer_plan", "fused_lane_layer", "band_conv"))
    cfg, net = _port(PACK, fields, params)
    got, m = make_eval_step(cfg, net, device="cpu")(batch)
    assert calls == {"fused_lane_layer_plan": 0, "fused_lane_layer": 0,
                     "band_conv": 2 * HALF["num_fuse_layers"]}, calls
    for k in ("cls", "reg"):
        _close(got[k], out[k], f"unfused half-width {k}", 1e-4)
    _close(m["loss"], loss, "unfused half-width loss", 1e-4)


# --- work() and work_bwd() at W = 64 ----------------------------------------------------

def test_work_counts_w_squared_products():
    """band_conv's and lane_plan's `work()` and `work_bwd()` at W = 64 and
    128: 2·W² operations per masked band row (band_conv: one product
    forward, two backward; lane_plan: lane_layer's, plus one per applied
    plan edge forward and two backward) and W-wide bytes."""
    rng = np.random.RandomState(43)
    n, j = NUM_WIN * STRIDE, len(SHIFTS)
    masks = torch.from_numpy(rng.rand(j, n) < 0.25)
    band = int(masks.sum())
    plan, groups, applied = _window_plan(rng)
    tplan = [torch.from_numpy(a) for a in plan]
    slots = plan[0].shape[0]
    for c in (W, 128):
        feat, w_rel = torch.zeros(n, c, dtype=torch.bfloat16), torch.zeros(14, c, c,
                                                                         dtype=torch.bfloat16)
        wf, wb = band_conv.work(feat, masks), band_conv.work_bwd(feat, masks)
        assert wf["band_rows"] == wb["band_rows"] == band
        assert wf["flops"] == 2 * c * c * band and wb["flops"] == 2 * 2 * c * c * band
        assert wf["bytes"] == 2 * n * c * 2 + j * n + j * c * c * 2
        assert wb["bytes"] == 3 * n * c * 2 + j * n + j * c * c * 6
        pf = lane_layer.work_plan(feat, masks, tplan[0], tplan[2], w_rel, NUM_WIN, groups)
        pb = lane_layer.work_plan_bwd(feat, masks, tplan[0], tplan[2], w_rel, NUM_WIN, groups)
        assert pf["edges"] == pb["edges"] == applied
        assert pf["flops"] == 2 * c * c * (band + n) + 2 * applied * c * c
        assert pb["flops"] == 2 * 2 * c * c * band + 3 * 2 * c * c * n + 2 * 2 * applied * c * c
        assert pf["bytes"] == (3 * n * c * 2 + j * n + (j + 1) * c * c * 2 + 4 * c * 4
                               + 3 * slots * 4 + 14 * c * c * 2)
        assert pb["bytes"] == (4 * n * c * 2 + n * c * 4 + j * n + (j + 1) * c * c * 6
                               + 8 * c * 4 + 3 * slots * 4 + 14 * c * c * 6)
