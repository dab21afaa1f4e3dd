"""The port's plan-merged LaneConv layer (ops/lane_layer.py
`fused_lane_layer_plan`, the layer with the window plan's aggregate inside
it) on CPU tensors (its plain versions), against the JAX package:
`fused_lane_layer_plan` in interpret mode for the op and its VJP, and
LaneGCN with `merge_plan_agg="auto"` against the JAX LaneGCN with the same
weights. Inputs come from numpy seeds.

Tolerances: float32 1e-5 of the output's (or gradient leaf's) largest
element: both sum the same fp32 products in other orders (the Pallas kernel
per 512-slot chunk through one-hot matmuls, the port per relation); bfloat16
3e-2 of (rms + |ref|) per element: both round the same intermediates, but a
reordered sum can flip one rounding (2^-8 relative), and the JAX kernel
rounds dx after every chunk where the port rounds once. The model: the loss
to rtol 1e-5 and every gradient to rtol 5e-4 / atol 5e-5, as the JAX
package holds its merged model to its separate one
(tests/test_pallas_kernels.py::test_plan_merged_layer_matches_separate_kernels).
"""

import dataclasses

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
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer_plan as jax_lane_plan

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig
from lanegcn_tpu_torch.config import (bench_pack_config, lanercnn_pack_config,
                                      windowed_pack_config)
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models import map_net
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.models.layers import init_parameters
from lanegcn_tpu_torch.ops import lane_layer, scenario_agg
from lanegcn_tpu_torch.train.loop import init_state, make_train_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

C = 128
SHIFTS = tuple(s for k in range(6) for s in (-(1 << k), 1 << k))
LR, DIL = (12, 13), tuple(range(12))
GROUPS = (LR, DIL)
NUM_WIN, STRIDE, ECAP = 2, 512, 1024
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(seed):
    """A grouped, chunk-aligned plan over two 512-row windows (window 0's
    left/right group spans one chunk, window 1's groups are small), random
    band masks, activations and weights, and an output cotangent."""
    rng = np.random.RandomState(seed)
    lu = np.full((NUM_WIN, ECAP), -1, np.int32)
    lv, rel = lu.copy(), np.zeros_like(lu)
    for w, (k_lr, k_dil) in enumerate([(300, 500), (60, 200)]):
        lu[w, :k_lr] = rng.randint(0, STRIDE, k_lr)
        lv[w, :k_lr] = rng.randint(0, STRIDE, k_lr)
        rel[w, :k_lr] = rng.choice(LR, k_lr)
        lu[w, 512:512 + k_dil] = rng.randint(0, STRIDE, k_dil)
        lv[w, 512:512 + k_dil] = rng.randint(0, STRIDE, k_dil)
        rel[w, 512:512 + k_dil] = np.sort(rng.choice(DIL, k_dil))
    n, j = NUM_WIN * STRIDE, len(SHIFTS)
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    gn = [a for _ in range(2) for a in ((1.0 + 0.1 * rng.randn(C)).astype(np.float32),
                                        (0.1 * rng.randn(C)).astype(np.float32))]
    arrays = [rng.randn(n, C).astype(np.float32), rng.randn(n, C).astype(np.float32),
              (rng.randn(j, C, C) / np.sqrt(C)).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32), *gn,
              (rng.randn(14, C, C) / np.sqrt(C)).astype(np.float32)]
    plan = [a.reshape(-1, 1) for a in (lu, lv, rel)]
    return arrays, masks, plan, rng.randn(n, C).astype(np.float32)


def _jax_fn(masks, plan, jdt):
    jm = jnp.asarray(masks, jdt)
    jplan = [jnp.asarray(a) for a in plan]

    def fn(feat, pre, wb, w2, g1w, g1b, g2w, g2b, w_rel):
        return jax_lane_plan(feat, pre, jm, wb, w2, g1w, g1b, g2w, g2b, w_rel, *jplan, NUM_WIN,
                             SHIFTS, GROUPS, 1e-5, True)
    return fn


def _port_fn(masks, plan):
    tm = torch.from_numpy(masks) > 0
    tplan = [torch.from_numpy(a) for a in plan]

    def fn(feat, pre, wb, w2, g1w, g1b, g2w, g2b, w_rel):
        return lane_layer.fused_lane_layer_plan(feat, pre, tm, wb, w2, g1w, g1b, g2w, g2b, w_rel,
                                                *tplan, NUM_WIN, SHIFTS, GROUPS)
    return fn


def _inputs(arrays, tag):
    """JAX and torch leaves; the GN vectors stay float32."""
    tdt, jdt = DTYPES[tag]
    gn = set(range(4, 8))
    jx = [jnp.asarray(a, jnp.float32 if i in gn else jdt) for i, a in enumerate(arrays)]
    tx = [torch.from_numpy(a).to(torch.float32 if i in gn else tdt).requires_grad_(True)
          for i, a in enumerate(arrays)]
    return jx, tx


def _close(port, ref, tag, what):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref)
    if tag == "float32":
        tol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
        assert float(err.max()) <= tol, f"{what}: max abs err {float(err.max())} > {tol}"
    else:
        rms = float(np.sqrt(np.mean(ref ** 2)))
        worst = float((err / (3e-2 * (rms + np.abs(ref)) + 1e-30)).max())
        assert worst <= 1.0, f"{what}: an element's error is {worst} x its tolerance"


@pytest.mark.parametrize("tag", ["float32", "bfloat16"])
def test_lane_plan_forward_matches_jax(tag):
    arrays, masks, plan, _ = _case(21)
    jx, tx = _inputs(arrays, tag)
    ref = _jax_fn(masks, plan, DTYPES[tag][1])(*jx)
    with torch.no_grad():
        got = _port_fn(masks, plan)(*tx)
    assert got.dtype == DTYPES[tag][0]
    _close(got, ref, tag, "out")
    # The plain version the kernel is held to on the card is the same function.
    plain = lane_layer.lane_plan_plain(
        tx[0], tx[1], torch.from_numpy(masks) > 0, *tx[2:8], tx[8],
        *(torch.from_numpy(a) for a in plan), NUM_WIN, SHIFTS, GROUPS)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("tag", ["float32", "bfloat16"])
def test_lane_plan_vjp_matches_jax(tag):
    """Gradients to feat, pre, wb, w2, the four GN vectors and w_rel."""
    arrays, masks, plan, g = _case(22)
    jx, tx = _inputs(arrays, tag)
    tdt, jdt = DTYPES[tag]
    _, vjp = jax.vjp(_jax_fn(masks, plan, jdt), *jx)
    ref = vjp(jnp.asarray(g, jdt))
    out = _port_fn(masks, plan)(*tx)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction), out.grad_fn
    out.backward(torch.from_numpy(g).to(tdt))
    names = ["feat", "pre", "wb", "w2", "g1w", "g1b", "g2w", "g2b", "w_rel"]
    for nm, t, want in zip(names, tx, ref):
        assert t.grad is not None and t.grad.dtype == t.dtype, nm
        _close(t.grad, want, tag, f"d{nm}")


def test_plain_merged_layer_equals_scenario_agg_then_lane_layer():
    """float32: the merged plain layer against the separate plain ops (the
    plan into pre, then the layer), forward and every gradient."""
    arrays, masks, plan, g = _case(23)
    tm = torch.from_numpy(masks) > 0
    tplan = [torch.from_numpy(a) for a in plan]
    results = []
    for merged in (True, False):
        _, tx = _inputs(arrays, "float32")
        feat, pre, wb, w2, g1w, g1b, g2w, g2b, w_rel = tx
        if merged:
            out = lane_layer.fused_lane_layer_plan(feat, pre, tm, wb, w2, g1w, g1b, g2w, g2b,
                                                   w_rel, *tplan, NUM_WIN, SHIFTS, GROUPS)
        else:
            temp = scenario_agg.scenario_aggregate(feat, pre, w_rel, *tplan, NUM_WIN, GROUPS)
            out = lane_layer.fused_lane_layer(feat, temp, tm, wb, w2, g1w, g1b, g2w, g2b, SHIFTS)
        out.backward(torch.from_numpy(g))
        results.append([out] + [t.grad for t in tx])
    for i, (a, b) in enumerate(zip(*results)):
        _close(a, b.detach().numpy(), "float32", f"output {i}")


# --- LaneGCN with merge_plan_agg="auto" -----------------------------------------

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=1)
# The pack of tests/test_pallas_kernels.py::test_plan_merged_layer_matches_separate_kernels.
PACK = dict(max_scenarios=4, max_actors=48, max_nodes=6 * 768, node_stride=768,
            max_plan_edges=1024, table_relations=(), max_edges_scale0=512,
            max_edges_dilated=768, max_edges_lr=128, max_a2m_edges=768, max_m2a_edges=768,
            max_a2a_edges=256)


@pytest.fixture(scope="module")
def world():
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=700 + i, num_corridors=3, num_actors=6) for i in range(4)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats.get("plan_edges", 0) > 0, stats
    jb = jax.tree.map(jnp.asarray, batch)
    jnet = JLaneGCN(jcfg.model)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3), jb)["params"]

    def objective(p):
        return jax_pred_loss(jnet.apply({"params": p}, jb), jb, jcfg.loss)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(objective))(params)
    return dict(batch=batch, params=jax.tree.map(np.asarray, params), loss=float(loss),
                grads=export_state_dict(jax.tree.map(np.asarray, grads), jcfg.model))


def _port(world, merge):
    cfg = Config(model=ModelConfig(**MODEL, merge_plan_agg=merge), pack=PackConfig(**PACK))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, world["params"], cfg.model)  # the same tree either way
    return cfg, net


@pytest.mark.parametrize("merge", ["auto", "off"])
def test_lanegcn_matches_jax_with_either_plan_setting(world, merge):
    """One JAX parameter set loads (strict) into the port with the plan
    merged and with it separate; each step's loss and every gradient
    against jax.grad, and the layers it ran."""
    cfg, net = _port(world, merge)
    calls = {"plan": 0, "layer": 0}
    plan_fn, layer_fn = map_net.fused_lane_layer_plan, map_net.fused_lane_layer

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    net, state = init_state(cfg, net=net, device="cpu")
    try:
        map_net.fused_lane_layer_plan = count("plan", plan_fn)
        map_net.fused_lane_layer = count("layer", layer_fn)
        metrics = make_train_step(cfg, net, state, device="cpu")(
            PackedBatch.from_numpy(world["batch"]), 0.0)
    finally:
        map_net.fused_lane_layer_plan, map_net.fused_lane_layer = plan_fn, layer_fn
    layers = 2 * MODEL["num_fuse_layers"]  # MapNet and M2M
    assert calls == ({"plan": layers, "layer": 0} if merge == "auto"
                     else {"plan": 0, "layer": layers}), calls
    np.testing.assert_allclose(float(metrics["loss"]), world["loss"], rtol=1e-5)
    ref = world["grads"]
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=5e-4, atol=5e-5, err_msg=name)


def test_merge_gate_follows_the_geometry():
    """The JAX package's gate: on when asked for and the node window can be
    the layer's tile (stride a multiple of 128, at least 512; plan slots per
    window a multiple of 512). The bench and windowed geometries and
    LaneRCNN's global graph (768-row windows, 2048 slots) merge; LaneRCNN's
    RoI windows (256 rows) do not; "off" never does."""
    on, off = ModelConfig(merge_plan_agg="auto"), ModelConfig()
    bench = bench_pack_config(8)
    n, slots = bench.max_nodes, (bench.max_nodes // 768) * 2048
    assert map_net.merge_plan(on, n, slots, n // 768)
    assert not map_net.merge_plan(off, n, slots, n // 768)
    roi = lanercnn_pack_config(8)
    w = roi.max_roi_nodes // 256
    assert not map_net.merge_plan(on, roi.max_roi_nodes, w * 512, w)
    assert not map_net.merge_plan(on, 3 * 768, 3 * 1000, 3)  # slots not a chunk multiple


# --- the kernels' schedule on the prepared plan, emulated on the CPU --------------

EMU_STRIDE, EMU_WIN, EMU_ROWS = 256, 3, 192  # window rows, windows, the bf16 blocks' rows
HOT = 100  # in-edges of one row (more than a 64-edge tile)


def _emu_case(seed, grouped):
    """Three 256-row windows, which 192-row blocks straddle: window 0 with a
    row of HOT in-edges among random edges, window 1 without edges, window 2
    with a few; grouped (left/right edges in the first 512-slot chunk, the
    dilated ones in the second) or not (one chunk)."""
    rng = np.random.RandomState(seed)
    ecap = 1024 if grouped else 512
    lu = np.full((EMU_WIN, ecap), -1, np.int32)
    lv, rel = lu.copy(), np.zeros_like(lu)
    for w, k in ((0, 400), (2, 40)):
        lu[w, :k] = rng.randint(0, EMU_STRIDE, k)
        if w == 0:
            lu[w, :HOT] = 7
        lv[w, :k] = rng.randint(0, EMU_STRIDE, k)
        rel[w, :k] = rng.choice(LR, k) if grouped else np.sort(rng.randint(0, 14, k))
        if grouped:
            lu[w, 512:512 + k // 2] = rng.randint(0, EMU_STRIDE, k // 2)
            lv[w, 512:512 + k // 2] = rng.randint(0, EMU_STRIDE, k // 2)
            rel[w, 512:512 + k // 2] = np.sort(rng.choice(DIL, k // 2))
    n, j = EMU_WIN * EMU_STRIDE, len(SHIFTS)
    t = lambda *shape, s=1.0: torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
    feat, pre, g = t(n, C), t(n, C), t(n, C)
    masks = torch.from_numpy(rng.rand(j, n) < 0.5)
    wb, w2, w_rel = t(j, C, C, s=C ** -0.5), t(C, C, s=C ** -0.5), t(14, C, C, s=C ** -0.5)
    gns = [1.0 + 0.1 * t(C), 0.1 * t(C), 1.0 + 0.1 * t(C), 0.1 * t(C)]
    plan = [torch.from_numpy(a.reshape(-1, 1)) for a in (lu, lv, rel)]
    return feat, pre, masks, wb, w2, gns, w_rel, plan, GROUPS if grouped else None, g


def _messages(prep, x, w_rel, pos, gather, transpose=False):
    """The message pass on the prepared tiles: ws[pos[e]] = rnd(x[gather[e]]
    @ W_r (or W_rᵀ)) for each tile's edges, one write per position."""
    ws = torch.zeros(prep.dst.shape[0], C)
    for t in range(int(prep.rel_tiles[-1])):
        r, first, cnt = prep.tiles[t].tolist()
        e = slice(first, first + cnt)
        w = w_rel[r].float()
        ws[pos[e].long()] = (x[gather[e].long()].float() @ (w.t() if transpose else w)).to(
            x.dtype).float()
    return ws


def _run_table(seg, s0, rows):
    """segment_sum.cuh `run_table`: the block's entries [blo, bhi) by two
    searches, then each row's run [lo, hi) from where its key starts and
    ends."""
    blo, bhi = (int(torch.searchsorted(seg, torch.tensor(k))) for k in (s0, s0 + rows))
    lo, hi = [0] * rows, [0] * rows
    for e in range(blo, bhi):
        r = int(seg[e]) - s0
        if e == blo or seg[e - 1] != seg[e]:
            lo[r] = e - blo
        if e + 1 == bhi or seg[e + 1] != seg[e]:
            hi[r] = e + 1 - blo
    return blo, lo, hi


def _add_runs(acc, ws, seg, block_rows):
    """Every block's rows add their runs of ws in position order."""
    n = acc.shape[0]
    for s0 in range(0, n, block_rows):
        rows = min(block_rows, n - s0)
        blo, lo, hi = _run_table(seg, s0, rows)
        for r in range(rows):
            for q in range(blo + lo[r], blo + hi[r]):
                acc[s0 + r] += ws[q]
    return acc


def _close_rel(got, want, what):
    tol = 1e-5 * max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("grouped", [True, False])
def test_forward_schedule_emulated_matches_the_plain_version(grouped):
    """lane_plan_fwd's schedule in fp32: prepare_plan's tiles, the messages
    at their destination positions (each rounded as written), 192-row
    blocks adding each row's run of the sorted dseg in position order into
    pre + the band products, then the tail: lane_plan_plain within 1e-5 of
    its largest element."""
    feat, pre, masks, wb, w2, gns, w_rel, plan, groups, _ = _emu_case(31, grouped)
    n = feat.shape[0]
    prep = scenario_agg.prepare_plan(*plan, EMU_WIN, EMU_STRIDE, groups, 14, backward=False)
    e = int(prep.rel_edges[-1])
    assert e > HOT and int(torch.bincount(prep.dst[:e].long()).max()) >= HOT
    ws = _messages(prep, feat, w_rel, prep.dpos, prep.src)
    temp = _add_runs(lane_layer._temp_plain(feat, pre, masks, wb, SHIFTS), ws, prep.dseg,
                     EMU_ROWS)
    out = lane_layer._tail_plain(feat, temp, w2, *gns, 1e-5)
    want_temp = lane_layer._plan_temp_plain(feat, pre, masks, wb, SHIFTS, w_rel, *plan, EMU_WIN,
                                            groups)
    _close_rel(temp, want_temp, "temp")
    assert not temp[EMU_STRIDE:2 * EMU_STRIDE].ne(
        lane_layer._temp_plain(feat, pre, masks, wb, SHIFTS)[EMU_STRIDE:2 * EMU_STRIDE]).any()
    _close_rel(out, lane_layer.lane_plan_plain(feat, pre, masks, wb, w2, *gns, w_rel, *plan,
                                               EMU_WIN, SHIFTS, groups), "out")


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("grouped", [True, False])
def test_backward_schedule_emulated_matches_the_plain_version(grouped, blocks):
    """lane_plan_bwd's schedule in fp32 from the forward's temp: the row pass,
    the transposed messages of rnd(d_temp) at the source positions, the dx
    pass adding each row's run of the sorted sseg after the band transposes
    (192-row blocks), and dW_rel as the dW pass's (block, relation) partials
    summed in block order: lane_plan_bwd_plain within 1e-5 of each output's
    largest element."""
    feat, pre, masks, wb, w2, gns, w_rel, plan, groups, g = _emu_case(32, grouped)
    prep = scenario_agg.prepare_plan(*plan, EMU_WIN, EMU_STRIDE, groups, 14)
    temp = lane_layer._plan_temp_plain(feat, pre, masks, wb, SHIFTS, w_rel, *plan, EMU_WIN,
                                       groups)
    d_temp, dx, dwb, dw2, dgn = lane_layer._band_bwd_plain(feat, temp, masks, wb, w2, *gns, g,
                                                           SHIFTS, 1e-5)
    dpre = d_temp.to(feat.dtype)
    ws = _messages(prep, dpre, w_rel, prep.spos, prep.dst, transpose=True)
    dx = _add_runs(dx, ws, prep.sseg, EMU_ROWS)
    part = {}
    total = int(prep.rel_tiles[-1])
    for b in range(blocks):
        for t in range(b * total // blocks, (b + 1) * total // blocks):
            r, first, cnt = prep.tiles[t].tolist()
            rows = slice(first, first + cnt)
            acc = feat[prep.src[rows].long()].t() @ dpre[prep.dst[rows].long()].float()
            part[b + r] = part.get(b + r, 0) + acc
    dwr = torch.zeros(14, C, C)
    for b in range(blocks):
        lo, hi = b * total // blocks, (b + 1) * total // blocks
        for r in range(14):
            if lo < hi and lo < int(prep.rel_tiles[r + 1]) and hi > int(prep.rel_tiles[r]) and \
                    int(prep.rel_tiles[r]) < int(prep.rel_tiles[r + 1]):
                dwr[r] += part[b + r]
    want = lane_layer.lane_plan_bwd_plain(feat, temp, masks, wb, w2, *gns, w_rel, *plan, EMU_WIN,
                                          groups, g, SHIFTS)
    got = (dx, dpre, dwb, dw2, *dgn, dwr)
    names = ["dx", "dpre", "dwb", "dw2", "dg1w", "dg1b", "dg2w", "dg2b", "dw_rel"]
    for nm, a, b in zip(names, got, want):
        _close_rel(a.float(), b.float(), nm)


def test_passed_prep_gives_the_same_outputs_and_gradients():
    """fused_lane_layer_plan with the stack's prepared plan and with none
    (prepared inside): the same output and the same gradients."""
    feat0, pre0, masks, wb0, w20, gns0, w_rel0, plan, groups, g = _emu_case(33, True)
    prep = scenario_agg.prepare_plan(*plan, EMU_WIN, EMU_STRIDE, groups, 14)
    runs = []
    for p in (prep, None):
        leaves = [x.clone().requires_grad_(True) for x in (feat0, pre0, wb0, w20, *gns0, w_rel0)]
        feat, pre, wb, w2, *rest = leaves
        out = lane_layer.fused_lane_layer_plan(feat, pre, masks, wb, w2, *rest, *plan, EMU_WIN,
                                               SHIFTS, groups, 1e-5, p)
        out.backward(g)
        runs.append([out.detach()] + [x.grad for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_merged_stack_prepares_the_plan_once_per_call(monkeypatch):
    """With merge_plan_agg="auto" the LaneConv stack calls prepare_plan once
    per call, with the source order only when a gradient is wanted, and
    hands that plan to every layer's fused_lane_layer_plan."""
    scens = [make_urban_scenario(seed=40 + i, num_corridors=3, num_actors=6) for i in range(2)]
    batch, _ = pack_batch(scens, windowed_pack_config(2), ModelConfig(**MODEL))
    graph = PackedBatch.from_numpy(batch).graph
    cfg = ModelConfig(**MODEL, merge_plan_agg="auto")
    stack = map_net.LaneConvStack(cfg, 2)
    init_parameters(stack, seed=0)
    made, seen = [], []
    prepare, layer = map_net.prepare_plan, map_net.fused_lane_layer_plan

    def counted_prepare(*a, **k):
        made.append((prepare(*a, **k), k.get("backward")))
        return made[-1][0]

    def counted_layer(*a):
        seen.append(a[-1])
        return layer(*a)

    monkeypatch.setattr(map_net, "prepare_plan", counted_prepare)
    monkeypatch.setattr(map_net, "fused_lane_layer_plan", counted_layer)
    for grad in (False, True):
        made.clear()
        seen.clear()
        feat = torch.randn(graph.capacity, MODEL["n_map"], requires_grad=grad)
        with torch.set_grad_enabled(grad):
            stack(feat, **map_net.graph_inputs(graph))
        assert [b for _, b in made] == [grad] and len(seen) == 2
        assert all(p is made[0][0] for p in seen)
        assert (made[0][0].spos is not None) == grad
