"""The double-width LaneGCN (n_map = n_actor = 256) against the JAX package
on the CPU, and the kernel wrappers' width dispatch at 256.

- The three forwards whose kernels take 256-wide rows (`lane_layer`,
  `row_tail` at K = 1 and Att's `edge_mlp`): their plain versions at W =
  256 against the Pallas kernels in interpret mode (as the JAX tests run
  them on the CPU), float32, within 2e-5 of max(1, max |reference|), the
  tolerance of tests/test_torch_half_width.py at 64: both sides sum the
  same fp32 products in other orders.
- The double-width LaneGCN's eval forward and loss, with the weights of
  one JAX init carried across by the bridge, against the JAX LaneGCN on
  the same JAX-built contiguous pack (3 scenarios: neighbour tables, flat
  destination-sorted fusion lists), float32, within 1e-4 of max(1, max
  |reference|), as tests/test_torch_model.py. The weights come from one
  numpy seed on the shapes of the JAX init (`jax.eval_shape`); one jit of
  the forward. The bridge round trip at 256.
- The wrappers' checks, called directly, for every C entry point: the
  three forwards and their backwards take 256; every other entry refuses
  it with a ValueError naming the kernel and 256, raised by the check
  before anything touches the card. `work()` at 256.
- chip_smoke.py's `double` geometry, on the CPU: a full-depth train step
  at 256 on the contiguous layout makes exactly the geometry's
  `per_train_step` calls, each through an entry built at 256; an eval
  forward at 256 on the bench layout reaches `scenario_agg` first of the
  kernels that do not take 256, with only segment sums before it
  (`refused_serve`). Its env phase's ptxas summary names the wide
  kernels, forwards and backwards.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_edge_mlp
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer as jax_lane_layer
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail as jax_row_tail

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.models.registry import get_model
from lanegcn_tpu_torch.ops import cuda, edge_mlp, lane_layer, row_tail, segment_sum
from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params
from test_torch_half_width import SHIFTS, _close, _dispatch, _seeded_params

W = 256
REL = 2e-5
MODEL = dict(n_map=W, n_actor=W, num_fuse_layers=2, num_att_layers=2)
PACK = dict(max_scenarios=3, max_actors=48, max_nodes=1536, max_edges_scale0=768,
            max_edges_dilated=1024, max_edges_lr=256, max_a2m_edges=3072,
            max_m2a_edges=3072, max_a2a_edges=1152)
WIDE = ("lane_layer", "row_tail", "edge_mlp")  # the kernels built at 256, both ways
WIDE_BWD = tuple(f"{k}_bwd" for k in WIDE)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gn(rng, k):
    """k GroupNorm weight and bias pairs at W."""
    return [a for _ in range(k) for a in ((1.0 + 0.1 * rng.randn(W)).astype(np.float32),
                                          (0.1 * rng.randn(W)).astype(np.float32))]


# --- the three plain forwards at W = 256 against the Pallas kernels -------------

def _lane_layer():
    """300 rows, ±1 .. ±32 band masks; the Pallas kernel takes a multiple of
    128 rows, so both sides' inputs are padded with zero rows, which the port
    reads outside [0, N) too."""
    rng = np.random.RandomState(1)
    n, big, j = 300, 384, len(SHIFTS)
    feat, pre = (rng.randn(n, W).astype(np.float32) for _ in range(2))
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    wb = (rng.randn(j, W, W) / np.sqrt(W)).astype(np.float32)
    w2 = (rng.randn(W, W) / np.sqrt(W)).astype(np.float32)
    gn = _gn(rng, 2)
    pad = lambda a: np.pad(a, ((0, big - n), (0, 0)))  # noqa: E731
    ref = jax_lane_layer(jnp.asarray(pad(feat)), jnp.asarray(pad(pre)),
                         jnp.asarray(np.pad(masks, ((0, 0), (0, big - n)))), jnp.asarray(wb),
                         jnp.asarray(w2), *map(jnp.asarray, gn), SHIFTS, 1e-5, True)
    t = torch.from_numpy
    port = lane_layer.lane_layer_plain(t(feat), t(pre), t(masks) > 0, t(wb), t(w2),
                                       *map(t, gn), SHIFTS)
    return port, np.asarray(ref)[:n]


def _row_tail():
    """K = 1 on 300 rows."""
    rng = np.random.RandomState(2)
    n = 300
    arrays = [rng.randn(n, W).astype(np.float32), rng.randn(n, W).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32), *_gn(rng, 2)]
    ref = jax_row_tail(*map(jnp.asarray, arrays), mode="interpret")
    return row_tail.row_tail_plain(*map(torch.from_numpy, arrays)), np.asarray(ref)


def _edge_mlp():
    """Att's flags on 300 rows, the last 50 padding (d = qg = cg = 0)."""
    rng = np.random.RandomState(3)
    e, n_pad = 300, 50
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    d = (rng.randn(e, 2) * 3.0).astype(np.float32)
    qg, cg = r(e, W), r(e, W)
    for a in (d, qg, cg):
        a[e - n_pad:] = 0.0
    arrays = [d, qg, cg, r(2, W), r(W), r(W, W), r(W) + 1.0, r(W), r(W, W), r(W) + 1.0, r(W),
              r(W, W)]
    ref = jax_edge_mlp(*map(jnp.asarray, arrays), True, True, 1e-5, True)
    return edge_mlp.edge_mlp_plain(*map(torch.from_numpy, arrays)), np.asarray(ref)


FORWARDS = {"lane_layer": _lane_layer, "row_tail": _row_tail, "edge_mlp": _edge_mlp}


@pytest.mark.parametrize("kernel", list(FORWARDS))
def test_plain_forward_at_256_matches_pallas(kernel):
    port, ref = FORWARDS[kernel]()
    assert tuple(port.shape) == ref.shape and ref.shape[1] == W
    _close(port, ref, f"{kernel} at {W}", REL)


# --- the double-width LaneGCN against the JAX LaneGCN ----------------------------

@pytest.fixture(scope="module")
def world():
    """One JAX-built contiguous pack of 3 urban scenarios, numpy-seeded
    params on the JAX init's shapes, the JAX forward and loss (one jit)."""
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=50 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    jb = jax.tree.map(jnp.asarray, batch)
    assert batch.graph.plan_lu is None and batch.fusion.pair_a2m is None
    jnet = JLaneGCN(jcfg.model)
    params = _seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jb)["params"])

    @jax.jit
    def forward(p):
        out = jnet.apply({"params": p}, jb)
        return out, jax_pred_loss(out, jb, jcfg.loss)["loss"]

    out, loss = forward(jax.tree.map(jnp.asarray, params))
    cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK))
    return dict(batch=batch, params=params, cfg=cfg, out=out, loss=loss)


def test_double_width_lanegcn_eval_matches_jax(world):
    """The eval forward and loss of LaneGCN at n_map = n_actor = 256 on the
    contiguous layout, the port's weights the JAX init's."""
    cfg = world["cfg"]
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, world["params"], cfg.model)
    got, m = make_eval_step(cfg, net, device="cpu")(world["batch"])
    for k in ("cls", "reg"):
        _close(got[k], world["out"][k], f"double-width {k}", 1e-4)
    _close(m["loss"], world["loss"], "double-width loss", 1e-4)


def test_weight_bridge_round_trips_at_256(world):
    """The 256-wide JAX params load strictly into the port's net and come
    back out as the same state dict; a LaneConv weight and an Att weight
    are the JAX kernels transposed."""
    cfg, params = world["cfg"], world["params"]
    sd = export_state_dict(params, cfg.model)
    net = LaneGCN(cfg.model, device="cpu", seed=5)
    load_jax_params(net, params, cfg.model)
    back = {k: v.numpy() for k, v in net.state_dict().items()}
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    wide = [k for k, v in back.items() if v.shape == (W, W)]
    assert any(k.startswith("map_net.fuse") for k in wide), wide[:5]
    assert any(k.startswith("a2a.") for k in wide), wide[:5]


# --- the wrappers' width dispatch ------------------------------------------------

def _wide_dispatch():
    """`_dispatch` at 256 (every entry of the port both ways but K = 1's
    row tail and Att's edge MLP) plus those two kernels' forwards and
    backwards, as {kernel: (its wrapper's check, the CUDA wrapper)}."""
    x, w, v = torch.zeros(256, W), torch.zeros(W, W), torch.zeros(W)
    d, kd, eps = torch.zeros(256, 2), torch.zeros(2, W), 1e-5
    chain = (v, w, v, v, w, v, v, w)  # bd, kdo, gdow, gdob, k1, gchw, gchb, kout
    return {
        **_dispatch(W),
        "row_tail": (lambda: row_tail._check(x, x, w, (v,) * 4),
                     lambda: row_tail._fwd_cuda(x, x, w, *(v,) * 4, eps)),
        "row_tail_bwd": (lambda: row_tail._check(x, x, w, (v,) * 4, "row_tail_bwd"),
                         lambda: row_tail.row_tail_bwd_cuda(x, x, w, *(v,) * 4, x)),
        "edge_mlp": (lambda: edge_mlp._check(d, x, x, kd, (w,) * 3, (v,) * 5),
                     lambda: edge_mlp._fwd_cuda(d, x, x, kd, *chain, eps)),
        "edge_mlp_bwd": (
            lambda: edge_mlp._check(d, x, x, kd, (w,) * 3, (v,) * 5, "edge_mlp_bwd"),
            lambda: edge_mlp.edge_mlp_bwd_cuda(d, x, x, kd, *chain, x)),
    }


ENTRY_POINTS = sorted(e for e in cuda.WIDTHS)


def test_dispatch_covers_every_entry_point():
    """The dispatch table names every C entry point's kernel (segment_sum,
    which takes any width, aside)."""
    assert sorted(cuda.entry_of(k) for k in _wide_dispatch()) == ENTRY_POINTS


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_width_dispatch_at_256(entry):
    """lane_layer_fwd, row_tail_fwd and edge_mlp_fwd and their backwards
    take rows 256 wide; every other entry refuses 256: a ValueError naming
    the kernel and 256, raised by the check before any launch."""
    name = entry[: -len("_fwd")] if entry.endswith("_fwd") else entry
    check, wrapper = _wide_dispatch()[name]
    if name in WIDE + WIDE_BWD:
        check()
        assert W in cuda.WIDTHS[entry]
    else:
        with pytest.raises(ValueError, match=rf"^{name}: .*not {W}$"):
            wrapper()
        assert cuda.WIDTHS[entry] == (64, 128)


def test_work_counts_w_squared_products_at_256():
    """Each wide forward's `work()` at W = 256: 2·W² operations per product
    row, 4x the 128-wide count on the same rows, W-wide bytes."""
    n, j = 384, len(SHIFTS)
    rng = np.random.RandomState(5)
    masks = torch.from_numpy(rng.rand(j, n) < 0.25)
    band_rows = int(masks.sum())
    wk = {c: lane_layer.work(torch.zeros(n, c, dtype=torch.bfloat16), masks) for c in (128, W)}
    assert wk[W]["flops"] == 2 * W * W * (band_rows + n) == 4 * wk[128]["flops"]
    assert wk[W]["bytes"] == 3 * n * W * 2 + j * n + (j + 1) * W * W * 2 + 4 * W * 4
    rt = {c: row_tail.work(n, 2, c) for c in (128, W)}
    assert rt[W]["flops"] == 2 * n * W * W == 4 * rt[128]["flops"]
    d = torch.from_numpy(rng.randn(n, 2).astype(np.float32))
    em = {c: edge_mlp.work(d, torch.ones(n, c), torch.ones(n, c)) for c in (128, W)}
    assert em[W]["flops"] == 2 * n * (2 * W + 3 * W * W)
    assert em[W]["flops"] - 4 * em[128]["flops"] == 2 * n * (2 * W - 4 * 2 * 128)


# --- chip_smoke.py's double geometry at 256 -------------------------------------------

def _call_order(monkeypatch, run, extra=()):
    """The kernel wrappers' calls, in order, while run() runs: the model's
    forward wrappers, the segment sum and `extra` (module, attribute, name)."""
    order = []
    targets = (cs.forward_capture().targets
               + [(segment_sum, "sorted_segment_sum", "segment_sum")] + list(extra))
    for mod, attr, name in targets:
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr,
                            lambda *a, _fn=fn, _n=name, **k: (order.append(_n), _fn(*a, **k))[1])
    run()
    return order


def _entries(calls):
    """{C entry: calls} of kernel names in a call order."""
    return dict(collections.Counter(k if k in cs.ANY_WIDTH else cuda.entry_of(k)
                                    for k in calls))


def test_double_train_step_launches_the_contiguous_step(monkeypatch):
    """A train step of the `double` geometry (full depth, on the CPU at 2
    scenarios) makes exactly the geometry's per_train_step calls (the
    contiguous geometry's: the three forwards and their backwards, and the
    segment sums), each through an entry whose WIDTHS hold 256."""
    spec = cs.GEOMETRIES["double"]
    assert spec["per_train_step"] == cs.GEOMETRIES["contiguous"]["per_train_step"]
    cfg = cs.pack_config("double", 2)
    packs, _, _, _ = cs.make_packs(cfg, 1, 2, seed0=0)
    bundle = get_model("lanegcn", cfg, device="cpu", seed=0)
    net, state = init_state(bundle.config, net=bundle.net, device="cpu")
    step = make_train_step(bundle.config, net, state, device="cpu", loss_fn=bundle.loss_fn,
                           metrics_fn=bundle.metrics_fn)
    bwd = [(row_tail, "row_tail_bwd_plain", "row_tail_bwd"),
           (edge_mlp, "edge_mlp_bwd_plain", "edge_mlp_bwd"),
           (lane_layer, "lane_layer_bwd_plain", "lane_layer_bwd")]
    order = _call_order(monkeypatch, lambda: step(PackedBatch.from_numpy(packs[0]), 0.0), bwd)
    assert _entries(order) == spec["per_train_step"]
    assert all(k in cs.ANY_WIDTH or W in cuda.WIDTHS[cuda.entry_of(k)] for k in order)


def test_double_bench_serve_refuses_at_the_plan_aggregate(monkeypatch):
    """An eval forward at 256 on the bench layout (the `double` geometry's
    `refused_serve`): the first kernel it reaches that is not built at 256
    is scenario_agg (WIDE_REFUSED_SERVE), with only segment sums before it."""
    spec = cs.GEOMETRIES["double"]
    geom, _ = spec["refused_serve"]
    cfg = cs.pack_config(geom, 2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **spec["model_fields"]))
    packs, _, _, _ = cs.make_packs(cfg, 1, 2, seed0=0, pack_kw=cs.pack_kwargs(geom))
    net = get_model("lanegcn", cfg, device="cpu", seed=0).net
    step = make_eval_step(cfg, net, device="cpu")
    order = _call_order(monkeypatch, lambda: step(PackedBatch.from_numpy(packs[0])))
    first = next(i for i, k in enumerate(order) if k not in WIDE + WIDE_BWD + cs.ANY_WIDTH)
    assert [order[first]] == list(cs.WIDE_REFUSED_SERVE) and first > 0
    assert set(order[:first]) <= set(cs.ANY_WIDTH)


def test_ptxas_entries_name_the_wide_kernels():
    """chip_smoke.py's env phase reads the wide kernels' registers and
    spills from nvcc's -Xptxas -v log by their own names, the forwards'
    and the backwards' (templates in namespace lgk::wide among them)."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN44_GLOBAL__N__79584a16_11_edge_mlp_cu_6f7dd86423edge_mlp_wide_tc_kernelEPKfif' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN..edge_mlp_wide_tc_kernel",
        "    120 bytes stack frame, 120 bytes spill stores, 128 bytes spill loads",
        "ptxas info    : Used 255 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_Z18edge_mlp_tc_kernelILi128EEvPKf' "
        "for 'sm_90a'",
        "ptxas info    : Used 168 registers, used 1 barriers",
    ])
    assert cs.kernel_name("_Z18edge_mlp_tc_kernelILi128EEvPKf") == "edge_mlp_tc_kernel"
    assert cs.ptxas_entries({"edge_mlp": log}, "_wide") == {"edge_mlp_wide_tc_kernel": [
        "120 bytes stack frame, 120 bytes spill stores, 128 bytes spill loads",
        "Used 255 registers, used 16 barriers"]}
    bwd = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN3lgk4wide23tail_bwd_wide_tc_kernelIfEEvPKT_PK13__nv_bfloat16S7_S7_PKfS9_S9_S9_"
        "PS5_SA_PfSB_SA_SA_SB_if' for 'sm_90a'",
        "ptxas info    : Used 255 registers, used 16 barriers",
        "ptxas info    : Compiling entry function '_Z18tail_bwd_tc_kernelIfLi128EEvPKT_' "
        "for 'sm_90a'",
        "ptxas info    : Used 154 registers, used 1 barriers",
    ])
    assert cs.ptxas_entries({"row_tail": bwd}, "_wide") == {
        "tail_bwd_wide_tc_kernel": ["Used 255 registers, used 16 barriers"]}
