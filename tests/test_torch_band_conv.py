"""The port's unfused LaneConv layer against the JAX package's, on the CPU:
`band_conv` (the band sum, csrc/band_conv.cu's plain version) and the
LaneConv stack with `ModelConfig(pallas_bands="off")`, which runs the band
sum and then the row tail (`fused_row_tail`), on packs with band masks and
on flat packs without them (`pack_batch(split_bands=False,
split_tables=False, scenario_plan=False)`, where every relation rides the
residue lists).

Inputs are seeded with numpy; both sides run on the CPU, the JAX op in
interpret mode (`band_conv(..., interpret=True)`), the JAX stack through its
masked roll and einsum, the port through its kernels' plain versions. One
JAX LaneGCN init (32 channels, 2 LaneConv layers, 2 Att per fusion stage)
is carried into the port by the weight bridge (a strict load); LaneRCNN
has its own.

Tolerances. `band_conv` in float32: each element within 1e-5 of the
reference's RMS (both sum the same fp32 products, dW's over N rows, in
other orders; fp32 rounds at 2^-24 a term). In bfloat16 both round the same
operands and sum exact products in fp32, so they differ by a flipped final
rounding at most: each element within 2^-7 · (rms + |ref|), two bf16 ulps
at the element's own size, floored at the RMS. Stacks and models: 1e-4
relative to max(1, max |reference|), each gradient leaf within 1e-4 of its
largest reference element, as tests/test_torch_layouts.py holds them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig, RoiPackConfig as JRoiPackConfig
from lanegcn_tpu.data.lane_roi import generate_lane_rois as jax_generate_lane_rois
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.packing_roi import pack_roi_batch as jax_pack_roi_batch
from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_scenario
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.models.lanercnn import LaneRCNN as JLaneRCNN, roi_loss as jax_roi_loss
from lanegcn_tpu.models.map_net import LaneConvStack as JLaneConvStack
from lanegcn_tpu.ops.pallas_band_conv import band_conv as jax_band_conv

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig, RoiPackConfig
from lanegcn_tpu_torch.config import contiguous_pack_config, flat_pack_config
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models import map_net
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.models.lanercnn import LaneRCNN, roi_loss, roi_metrics
from lanegcn_tpu_torch.ops import band_conv as band_conv_mod
from lanegcn_tpu_torch.ops.band_conv import band_conv, band_conv_bwd_plain, band_conv_plain
from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step
from lanegcn_tpu_torch.utils.weights import _fuse_stack, _get_leaf, _to_torch, export_state_dict
from lanegcn_tpu_torch.utils.weights import load_jax_params

SHIFTS = (-1, -2, -4, -8, -16, -32, 1, 2, 4, 8, 16, 32)
MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=2)
PACKS = {
    # 512-row node windows with a window plan, band masks, 32-row actor
    # windows and fusion pair plans; the plan's residue rides the lists.
    "windowed": dict(
        max_scenarios=3, max_actors=96, max_nodes=512 * 4, node_stride=512,
        max_plan_edges=512, table_relations=(), actor_stride=32, fusion_pairs=True,
        pair_chunk=64, max_edges_scale0=512, max_edges_dilated=512, max_edges_lr=512,
        max_a2m_edges=6144, max_m2a_edges=6144, max_a2a_edges=1536),
    # Contiguous nodes packed flat: no bands, no tables, no plan.
    "flat": dict(
        max_scenarios=3, max_actors=48, max_nodes=1536, max_edges_scale0=1024,
        max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=3072, max_m2a_edges=3072,
        max_a2a_edges=1152),
}
FLAT = dict(split_bands=False, split_tables=False, scenario_plan=False)
REL = 1e-4


# --- band_conv ---------------------------------------------------------------


def _band_inputs(n, c, seed=1):
    """feat, masks with the wrap rows cleared (the kernels read zeros past
    the ends where jnp.roll would wrap; real band masks never mark such a
    row), weights and a cotangent, as tests/test_pallas_kernels.py builds them."""
    j = len(SHIFTS)
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n, c)).astype(np.float32)
    m = rng.random((j, n)) < 0.6
    for k, s in enumerate(SHIFTS):
        if s > 0:
            m[k, n - s:] = False
        else:
            m[k, :-s] = False
    w = (rng.normal(size=(j, c, c)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    return feat, m, w, g


@pytest.mark.parametrize("n,dtype", [(512, "float32"), (1024, "float32"), (512, "bfloat16")])
def test_band_conv_matches_jax_kernel(n, dtype):
    """band_conv_plain, and dfeat and dW through the port's autograd
    Function (band_conv_bwd_plain on the CPU), against the Pallas kernel in
    interpret mode and its jax.vjp; the masks go in as bool on the port's
    side and as 0/1 in feat's dtype on the JAX side."""
    feat, m, w, g = _band_inputs(n, 128)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jnp.asarray(m, jdt)
    out, vjp = jax.vjp(lambda f, ww: jax_band_conv(f, jm, ww, SHIFTS, True),
                       jnp.asarray(feat, jdt), jnp.asarray(w, jdt))
    dx, dw = vjp(jnp.asarray(g, jdt))

    tf = torch.tensor(feat).to(tdt).requires_grad_()
    tw = torch.tensor(w).to(tdt).requires_grad_()
    got = band_conv(tf, torch.tensor(m), tw, SHIFTS)
    got.backward(torch.tensor(g).to(tdt))
    assert torch.equal(got, band_conv_plain(tf.detach(), torch.tensor(m), tw.detach(), SHIFTS))
    for name, port, ref in (("out", got, out), ("dfeat", tf.grad, dx), ("dW", tw.grad, dw)):
        assert port.dtype == tdt, (name, port.dtype)
        port = port.detach().float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        rms = float(np.sqrt((ref ** 2).mean()))
        err = np.abs(port - ref)
        if dtype == "float32":
            assert err.max() <= 1e-5 * rms, f"{name}: max abs err {err.max()} > 1e-5 · {rms}"
        else:
            worst = float((err / (2.0 ** -7 * (rms + np.abs(ref)))).max())
            assert worst <= 1.0, f"{name}: an element is {worst} x its bf16 tolerance"


def test_band_conv_bwd_plain_rounds_the_cotangent_to_feat_dtype():
    """The backward takes g in any dtype and rounds it to feat's first, as
    the JAX op's _bwd_impl does; dW comes back in fp32."""
    feat, m, w, g = _band_inputs(256, 128, seed=4)
    fb, wb = torch.tensor(feat).bfloat16(), torch.tensor(w).bfloat16()
    dx32, dw32 = band_conv_bwd_plain(fb, torch.tensor(m), wb, torch.tensor(g), SHIFTS)
    dxb, dwb = band_conv_bwd_plain(fb, torch.tensor(m), wb, torch.tensor(g).bfloat16(), SHIFTS)
    assert dx32.dtype == torch.bfloat16 and dw32.dtype == torch.float32
    assert torch.equal(dx32, dxb) and torch.equal(dw32, dwb)


# --- the LaneConv stack and LaneGCN with pallas_bands="off" -------------------


# The bf16 forward kernel's blocks (csrc/band_conv.cu band_conv_tc_kernel on
# lane_band.cuh band_fwd_tc): BLOCK rows a block, three warpgroups of
# BLOCK // 3, and the block's rows with a ±HALO-row halo of feat.
BLOCK, BLOCK_WGS, HALO = 192, 3, 32


def _band_conv_blocks(feat, masks, w, shifts):
    """band_conv_plain's arithmetic in the bf16 forward kernel's schedule:
    per block its halo tile (zeros outside [0, N)) and its rows' masks (zero
    past N); per warpgroup one fp32 accumulator from zero, the relations in
    order, a relation none of the warpgroup's rows has skipped; the rows
    below N rounded once to feat's dtype. Returns the output and the
    (block, warpgroup, relation) products run."""
    n, c = feat.shape
    rows = BLOCK // BLOCK_WGS
    f, m = feat.float(), masks.float()
    out = torch.empty(n, c, dtype=feat.dtype)
    ran = []
    for b, b0 in enumerate(range(0, n, BLOCK)):
        halo = torch.zeros(BLOCK + 2 * HALO, c)
        lo, hi = max(b0 - HALO, 0), min(b0 + BLOCK + HALO, n)
        halo[lo - (b0 - HALO):hi - (b0 - HALO)] = f[lo:hi]
        mb = torch.zeros(len(shifts), BLOCK)
        mb[:, :min(BLOCK, n - b0)] = m[:, b0:b0 + BLOCK]
        for wg in range(BLOCK_WGS):
            r0 = wg * rows
            acc = torch.zeros(rows, c)
            for j, s in enumerate(shifts):
                mj = mb[j, r0:r0 + rows]
                if not bool(mj.any()):
                    continue
                ran.append((b, wg, j))
                a = halo[HALO + r0 + s:HALO + r0 + s + rows] * mj[:, None]
                acc = acc + a @ w[j].float()
            keep = min(rows, n - (b0 + r0))
            if keep > 0:
                out[b0 + r0:b0 + r0 + keep] = acc[:keep].to(feat.dtype)
    return out, ran


@pytest.mark.parametrize("n", [1, 191, 193, 385], ids=["one-row", "block-less-1",
                                                      "block-plus-1", "two-blocks-plus-1"])
def test_band_conv_block_schedule_emulated_matches_plain(n):
    """The bf16 forward kernel's blocks, halos and skipped relations through
    the plain arithmetic, at fp32, against `band_conv_plain`: within 1e-5
    relative (the products' sums in another order), shifts ±1 .. ±32, the
    ±32 relations set on the 40 rows around each block edge (their sources
    cross it), relation 3's mask all zero (no warpgroup runs it)."""
    rng = np.random.RandomState(n)
    j = len(SHIFTS)
    feat = torch.from_numpy(rng.randn(n, 128).astype(np.float32))
    masks = rng.rand(j, n) < 0.5
    masks[3] = False
    for k, s in enumerate(SHIFTS):
        if abs(s) == 32:
            for edge in range(BLOCK, n + BLOCK, BLOCK):
                masks[k, max(edge - 20, 0):min(edge + 20, n)] = True
    masks = torch.from_numpy(masks)
    w = torch.from_numpy((rng.randn(j, 128, 128) / np.sqrt(128)).astype(np.float32))
    want = band_conv_plain(feat, masks, w, SHIFTS)
    got, ran = _band_conv_blocks(feat, masks, w, SHIFTS)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert not any(jj == 3 for _, _, jj in ran)
    assert {jj for _, _, jj in ran} == {jj for jj in range(j) if bool(masks[jj].any())}


@pytest.fixture(scope="module")
def world():
    """Both JAX-built packs and one JAX LaneGCN init (pallas_bands="off"),
    built on first use."""
    return {}


def _world(w, layout):
    if layout not in w:
        jcfg = JConfig(model=JModelConfig(**MODEL, pallas_bands="off"),
                       pack=JPackConfig(**PACKS[layout]))
        scens = [jax_make_urban(seed=60 + i, num_corridors=3, num_actors=8) for i in range(3)]
        batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model,
                                      **(FLAT if layout == "flat" else {}))
        assert stats["packed_scenarios"] == 3
        assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
        jb = jax.tree.map(jnp.asarray, batch)
        if "params" not in w:
            w["jnet"] = JLaneGCN(jcfg.model)
            w["params"] = jax.jit(w["jnet"].init)(jax.random.PRNGKey(0), jb)["params"]
            w["params_np"] = jax.tree.map(np.asarray, w["params"])
        w[layout] = dict(batch=batch, jb=jb, jcfg=jcfg)
    return w[layout]


def _port_net(w, bands="off"):
    cfg = Config(model=ModelConfig(**MODEL, pallas_bands=bands))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, w["params_np"], cfg.model)
    return cfg, net


def _close(port, ref, what, rel=REL):
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max())) if ref.size else 0.0
    err = float(np.abs(port - ref).max()) if port.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _grad_close(port, ref, what):
    tol = 1e-4 * float(np.abs(ref).max()) + 1e-9
    err = float(np.abs(port.numpy() - ref).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _stack_inputs(g):
    plan = None if g.plan_lu is None else (g.plan_lu, g.plan_lv, g.plan_rel, g.plan_scen)
    return (g.edges, g.bands, g.tables, g.table_inv), dict(plan=plan, spill=g.spill_pair)


@pytest.mark.parametrize("layout", ["windowed", "flat"])
def test_stack_matches_jax_stack(world, layout):
    """MapNet's LaneConv stack alone: the port's unfused stack against the
    JAX stack with pallas_bands="off" on the same JAX-built pack, forward,
    d feat and every parameter's gradient under one seeded cotangent. The
    input is the stack's own, MapNet's node embedding of the pack (the
    port's, handed to both): on N(0, 1) rows a LaneConv ReLU can sit within
    the fp32 reorder error of zero, and then the two gradients differ by
    that ReLU's whole term."""
    w = _world(world, layout)
    jg = w["jb"].graph
    if layout == "windowed":
        assert jg.bands and jg.plan_lu is not None and int((jg.plan_lu >= 0).sum()) > 0
    else:
        assert not jg.bands and not jg.tables and jg.plan_lu is None
    cfg, net = _port_net(world)
    graph = PackedBatch.from_numpy(w["batch"]).graph
    with torch.no_grad():
        feat = torch.relu(net.map_net.input(graph.ctrs) + net.map_net.seg(graph.feats)).numpy()
    cot = np.random.RandomState(3).randn(*feat.shape).astype(np.float32)
    stack = JLaneConvStack(w["jcfg"].model, MODEL["num_fuse_layers"])
    args, kw = _stack_inputs(jg)

    @jax.jit
    def run(p, x, ct):
        out, vjp = jax.vjp(lambda pp, xx: stack.apply({"params": pp}, xx, *args, **kw), p, x)
        return out, vjp(ct)

    out, (dp, dfeat) = run(world["params"]["map_net"]["fuse"], jnp.asarray(feat),
                           jnp.asarray(cot))
    fuse = net.map_net.fuse
    x = torch.tensor(feat, requires_grad=True)
    got = fuse(x, **map_net.graph_inputs(graph))
    got.backward(torch.tensor(cot))
    _close(got, out, f"{layout} out")
    _close(x.grad, dfeat, f"{layout} dfeat")
    want = {}
    for tkey, fpath, kind, rel in _fuse_stack("fuse", (), cfg.model.num_scales,
                                             MODEL["num_fuse_layers"]):
        leaf = np.asarray(_get_leaf(dp, fpath), np.float32)
        want[tkey] = _to_torch(leaf if rel is None else leaf[rel], kind)
    got_grads = dict(fuse.named_parameters(prefix="fuse"))
    assert set(got_grads) == set(want)
    for name, p in got_grads.items():
        _grad_close(p.grad, want[name], f"{layout} {name}")


def test_train_step_on_flat_pack_matches_jax(world):
    """One fp32 make_train_step of LaneGCN on the flat pack: the loss and
    every gradient leaf against jax.value_and_grad of the JAX pred_loss."""
    w = _world(world, "flat")
    jnet, jcfg, jb = world["jnet"], w["jcfg"], w["jb"]

    def objective(p):
        return jax_pred_loss(jnet.apply({"params": p}, jb), jb, jcfg.loss)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(objective))(world["params"])
    grads = export_state_dict(jax.tree.map(np.asarray, grads), jcfg.model)
    cfg, net = _port_net(world)
    cfg = Config(model=cfg.model, pack=PackConfig(**PACKS["flat"]))
    net, state = init_state(cfg, net=net, device="cpu")
    metrics = make_train_step(cfg, net, state, device="cpu")(w["batch"], 0.0)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(grads)
    for name, g in got.items():
        assert g is not None, f"{name}: no gradient"
        _grad_close(g, grads[name], f"flat {name}")


def test_fused_and_unfused_layers_agree_on_one_state_dict(world, monkeypatch):
    """One state dict loads strictly into LaneGCN with the fused layer
    ("auto") and with the unfused one ("off"); on the banded pack the two
    eval steps agree (fp32, plain versions). The unfused step calls
    band_conv once per LaneConv layer (MapNet's and M2M's), the fused one
    never."""
    w = _world(world, "windowed")
    cfg_on, net_on = _port_net(world, bands="auto")
    cfg_off, net_off = _port_net(world, bands="off")
    net_off.load_state_dict(net_on.state_dict(), strict=True)
    calls = []
    real = band_conv_mod.band_conv
    monkeypatch.setattr(map_net, "band_conv", lambda *a: calls.append(1) or real(*a))
    out_on, m_on = make_eval_step(cfg_on, net_on, device="cpu")(w["batch"])
    assert not calls
    out_off, m_off = make_eval_step(cfg_off, net_off, device="cpu")(w["batch"])
    assert len(calls) == 2 * MODEL["num_fuse_layers"]
    for k in ("cls", "reg"):
        _close(out_off[k], out_on[k].numpy(), f"fused vs unfused {k}")
    _close(m_off["loss"], float(m_on["loss"]), "fused vs unfused loss")


def test_flat_pack_config_holds_left_right_whole():
    """32 urban scenarios packed flat (the JAX CLI's explicit graph-parallel
    pack): flat_pack_config drops nothing and the pack has no bands, tables
    or plan; contiguous_pack_config's left/right lists, sized for the tabled
    layout, drop 20-40 % of those edges there."""
    s = 32
    scens = [make_urban_scenario(seed=i, num_corridors=7, num_actors=16) for i in range(s)]
    batch, stats = pack_batch(scens, flat_pack_config(s), ModelConfig(), **FLAT)
    assert stats["packed_scenarios"] == s
    assert not any(v for k, v in stats.items() if k.startswith(("dropped", "skipped"))), stats
    assert not batch.graph.bands and not batch.graph.tables and batch.graph.plan_lu is None
    _, tabled = pack_batch(scens, contiguous_pack_config(s), ModelConfig(), **FLAT)
    for nm in ("left", "right"):
        kept = int(batch.graph.edges[nm].mask.sum())
        assert 0.2 < tabled[f"dropped_{nm}"] / kept < 0.4, (nm, tabled[f"dropped_{nm}"], kept)


# --- LaneRCNN with pallas_bands="off" -------------------------------------------

RCNN_MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2, pallas_bands="off")
RCNN_PACK = dict(max_scenarios=3, max_rois=36, max_interest_nodes=512, max_edges_scale0=1024,
                 max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=1024,
                 max_pool_edges=16384, max_a2r_edges=2048, max_roi_nodes=2048,
                 max_global_nodes=1536)


def test_lanercnn_unfused_forward_matches_jax():
    """LaneRCNN's fp32 eval step with pallas_bands="off" (its RoI and
    global stacks through band_conv and the row tail) against the JAX
    LaneRCNN with pallas_bands="off" on the same JAX-built RoI pack, with
    the JAX init carried across by the weight bridge."""
    jcfg = JConfig(model=JModelConfig(**RCNN_MODEL), roi_pack=JRoiPackConfig(**RCNN_PACK))
    scens = [jax_generate_lane_rois(jax_make_scenario(seed=s, num_corridors=2, num_actors=6))
             for s in (40, 41, 42)]
    jb, stats = jax_pack_roi_batch(copy.deepcopy(scens), jcfg.roi_pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert jb.bands, "the RoI pack carries band masks"
    jbatch = jax.tree.map(jnp.asarray, jb)
    jnet = JLaneRCNN(jcfg.model)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jbatch)["params"]

    @jax.jit
    def ev(p, b):
        out = jnet.apply({"params": p}, b)
        return out, jax_roi_loss(out, b, jcfg.loss)["loss"]

    jout, jloss = ev(params, jbatch)
    cfg = Config(model=ModelConfig(**RCNN_MODEL), roi_pack=RoiPackConfig(**RCNN_PACK))
    net = LaneRCNN(cfg.model, device="cpu")
    load_jax_params(net, jax.tree.map(np.asarray, params), cfg.model, "lanercnn")
    out, m = make_eval_step(cfg, net, device="cpu", loss_fn=roi_loss,
                            metrics_fn=roi_metrics)(jb)
    for k in ("pred_logics", "pred_goals", "pred_trajs"):
        _close(out[k], np.asarray(jout[k]), f"lanercnn {k}")
    _close(m["loss"], float(jloss), "lanercnn loss")
