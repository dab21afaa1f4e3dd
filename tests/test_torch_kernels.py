"""The port's four kernel ops (plain PyTorch versions, as their wrappers run
them on CPU tensors) against the JAX package's Pallas kernels, run as the
JAX tests run them on the CPU: interpret mode.

Inputs come from a numpy seed and feed both sides. Tolerances: both sides
compute in float32 with unit-scale inputs and sum the same 128-term
products in different orders, so they agree to ~1e-6; the bound is 1e-5
absolute (1e-5 relative on the accumulating outputs, whose scale grows
with the number of summed edges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.data.packing import build_pair_plan
from lanegcn_tpu.graph import PairPlan as JPairPlan
from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer as jax_lane_layer
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail as jax_row_tail
from lanegcn_tpu.ops.pallas_scenario_agg import scenario_aggregate as jax_scenario_agg
from lanegcn_tpu.ops.pallas_win_edge import win_edge_mlp as jax_win_edge

from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops.lane_layer import fused_lane_layer
from lanegcn_tpu_torch.ops.row_tail import fused_row_tail
from lanegcn_tpu_torch.ops.scenario_agg import GROUPED_MIN_CAP, scenario_aggregate
from lanegcn_tpu_torch.ops.win_edge import win_edge_mlp

C = 128
ATOL = 1e-5


def _close(port, ref, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref, np.float32),
                               rtol=rtol, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# --- lane_layer -------------------------------------------------------------

SHIFTS = tuple(s for k in range(6) for s in (-(1 << k), 1 << k))


@pytest.mark.parametrize("ends", [False, True], ids=["random-bands", "bands-at-ends"])
def test_lane_layer_matches_pallas(ends):
    rng = np.random.RandomState(0)
    n, j = 256, len(SHIFTS)
    feat = rng.randn(n, C).astype(np.float32)
    pre = rng.randn(n, C).astype(np.float32)
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    if ends:
        # Band rows whose source falls outside [0, N): both sides read zeros.
        for jj, s in enumerate(SHIFTS):
            masks[jj, :32] = 1.0
            masks[jj, -32:] = 1.0
    wb = (rng.randn(j, C, C) / np.sqrt(C)).astype(np.float32)
    w2 = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    g = [(1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
         (1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)]
    ref = jax_lane_layer(_j(feat), _j(pre), _j(masks), _j(wb), _j(w2), *map(_j, g),
                         SHIFTS, 1e-5, True)
    out = fused_lane_layer(_t(feat), _t(pre), _t(masks) > 0, _t(wb), _t(w2), *map(_t, g),
                           SHIFTS)
    _close(out, ref)


# The bf16 lane_layer_bwd kernel's dx pass runs the band transpose on tensor
# cores, whose operands are bf16, while d_temp is fp32 (as in the Pallas
# backward). It splits d_temp into bf16 hi + lo and sums both products in
# one fp32 accumulator. Held here, in torch, before any run on a card: the
# emulated split dx against the plain backward's fp32 dx within 1/16 of the
# tolerance chip_smoke.py holds the bf16 kernel to (TOL 3e-2 per element of
# rms + |plain|, RMS_TOL 1e-2), on the band masks of a real pack.
SPLIT_TOL, SPLIT_RMS_TOL = 3e-2 / 16, 1e-2 / 16


def _small_pack_bands():
    """Band masks [J, N] and shifts of a 3-scenario windowed pack with
    256-row node windows."""
    import dataclasses

    from lanegcn_tpu_torch.config import ModelConfig, band_shift, windowed_pack_config
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
    from lanegcn_tpu_torch.graph import PackedBatch

    model = ModelConfig(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=1)
    scens = [make_urban_scenario(seed=40 + i, num_corridors=3, num_actors=6) for i in range(3)]
    cfg = dataclasses.replace(windowed_pack_config(3), node_stride=256, max_nodes=1024)
    b, st = pack_batch(scens, cfg, model)
    assert st["packed_scenarios"] == 3
    bands = PackedBatch.from_numpy(b).graph.bands
    names = sorted(bands, key=lambda nm: (band_shift(nm) < 0, abs(band_shift(nm))))
    return torch.stack([bands[nm] for nm in names]), tuple(band_shift(nm) for nm in names)


def test_lane_layer_bwd_split_dx_matches_plain_and_jax_vjp():
    from lanegcn_tpu_torch.ops.lane_layer import (_band_bwd_plain, _shift_rows, _temp_plain,
                                                  lane_layer_bwd_plain)
    from lanegcn_tpu_torch.ops.row_tail import tail_bwd_plain

    masks, shifts = _small_pack_bands()
    n, j = masks.shape[1], len(shifts)
    assert n == 1024 and j == 12 and masks.any(1).all()
    rng = np.random.RandomState(3)
    feat = rng.randn(n, C).astype(np.float32)
    pre = rng.randn(n, C).astype(np.float32)
    wb = (rng.randn(j, C, C) / np.sqrt(C)).astype(np.float32)
    w2 = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    gn = [(1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
          (1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)]
    g = rng.randn(n, C).astype(np.float32)

    # The split product, in bf16 as the kernel runs it.
    bf = torch.bfloat16
    tf, tpre, twb, tw2, tg = (_t(a).to(bf) for a in (feat, pre, wb, w2, g))
    tgn = [_t(a) for a in gn]
    temp = _temp_plain(tf, tpre, masks, twb, shifts)
    d_temp, d_y, *_ = tail_bwd_plain(temp, tf, tw2, *tgn, tg)
    hi = d_temp.to(bf)
    lo = (d_temp - hi.float()).to(bf)
    dx = d_y.clone()
    for jj, s in enumerate(shifts):
        m = masks[jj].float()[:, None]
        w_t = twb[jj].float().t()
        dx = dx + _shift_rows(hi.float() * m, -s) @ w_t + _shift_rows(lo.float() * m, -s) @ w_t
    want = _band_bwd_plain(tf, temp, masks, twb, tw2, *tgn, tg, shifts, 1e-5)[1]
    rms = float(want.square().mean().sqrt())
    err = (dx - want).abs()
    assert float((err / (SPLIT_TOL * (rms + want.abs()))).max()) <= 1.0
    assert float(err.square().mean().sqrt()) <= SPLIT_RMS_TOL * rms

    # The plain backward (fp32) against the Pallas VJP at the same pack.
    jm = _j(masks.numpy().astype(np.float32))
    args = tuple(map(_j, (feat, pre, wb, w2, *gn)))
    _, vjp = jax.vjp(lambda f, p, b_, w, a, b, c, d: jax_lane_layer(
        f, p, jm, b_, w, a, b, c, d, shifts, 1e-5, True), *args)
    ref = vjp(_j(g))
    t32 = [_t(a) for a in (feat, pre, wb, w2)]
    temp32 = _temp_plain(t32[0], t32[1], masks, t32[2], shifts)
    got = lane_layer_bwd_plain(t32[0], temp32, masks, t32[2], t32[3], *tgn, _t(g), shifts)
    # (dx, dpre, dwb, dw2, dg1w, dg1b, dg2w, dg2b) against the VJP's (feat,
    # pre, wb, w2, g1w, g1b, g2w, g2b)
    # at tests/test_torch_grads.py's bound: 2e-5 of max(1, max |ref|)
    for nm, a, b in zip(("dx", "dpre", "dwb", "dw2", "dg1w", "dg1b", "dg2w", "dg2b"), got, ref):
        b = np.asarray(b, np.float32)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 2e-5 * max(1.0, float(np.abs(b).max())), (nm, err)


# --- scenario_agg ------------------------------------------------------------

R = 14
LR = (12, 13)
DIL = tuple(range(12))


def _plan_case(seed, num_win, stride, ecap, grouped, fill):
    """Window plan with per-window valid counts `fill` ([(lr, dil)] when
    grouped: chunk-aligned groups, left/right first; [k] otherwise)."""
    rng = np.random.RandomState(seed)
    n = num_win * stride
    lu = np.full((num_win, ecap), -1, np.int32)
    lv = np.full((num_win, ecap), -1, np.int32)
    rel = np.full((num_win, ecap), -1, np.int32)
    for w in range(num_win):
        if grouped:
            k_lr, k_dil = fill[w]
            lu[w, :k_lr] = rng.randint(0, stride, k_lr)
            lv[w, :k_lr] = rng.randint(0, stride, k_lr)
            rel[w, :k_lr] = rng.choice(LR, k_lr)
            o = -(-k_lr // 512) * 512
            lu[w, o : o + k_dil] = rng.randint(0, stride, k_dil)
            lv[w, o : o + k_dil] = rng.randint(0, stride, k_dil)
            rel[w, o : o + k_dil] = np.sort(rng.choice(DIL, k_dil))
        else:
            k = fill[w]
            lu[w, :k] = rng.randint(0, stride, k)
            lv[w, :k] = rng.randint(0, stride, k)
            rel[w, :k] = rng.randint(0, R, k)
    feat = rng.randn(n, C).astype(np.float32)
    temp = rng.randn(n, C).astype(np.float32)
    w_rel = (rng.randn(R, C, C) / np.sqrt(C)).astype(np.float32)
    return feat, temp, w_rel, lu.reshape(-1, 1), lv.reshape(-1, 1), rel.reshape(-1, 1)


@pytest.mark.parametrize("case", [
    # Grouped layout; window 1 holds only padding chunks.
    dict(grouped=True, ecap=GROUPED_MIN_CAP, fill=[(300, 500), (0, 0)]),
    # Grouped layout, left/right group spanning two chunks.
    dict(grouped=True, ecap=3 * 512, fill=[(600, 100), (10, 400)]),
    # Single-group (small) plan with ragged valid counts.
    dict(grouped=False, ecap=256, fill=[100, 7]),
    # Empty plan: the output is temp.
    dict(grouped=False, ecap=256, fill=[0, 0]),
], ids=["grouped-padding-window", "grouped-two-chunk-lr", "single-group", "empty-plan"])
def test_scenario_agg_matches_pallas(case):
    num_win, stride = 2, 256
    args = _plan_case(1, num_win, stride, case["ecap"], case["grouped"], case["fill"])
    groups = (LR, DIL) if case["grouped"] else None
    ref = jax_scenario_agg(*map(_j, args), num_scen=num_win, mode="interpret", groups=groups)
    out = scenario_aggregate(*map(_t, args), num_win, groups)
    _close(out, ref, rtol=1e-5)
    if not any(np.ravel(case["fill"])):
        np.testing.assert_array_equal(out.numpy(), args[1])


def test_scenario_agg_unaligned_group_drops_like_pallas():
    """Under `groups`, an edge whose relation is outside its chunk's group is
    not applied (the TPU kernel's contract); both sides agree."""
    feat, temp, w_rel, lu, lv, rel = _plan_case(
        2, 2, 256, GROUPED_MIN_CAP, True, [(200, 300), (40, 50)])
    rel = rel.copy()
    rel[5, 0] = 3  # a dilated relation inside the left/right chunk
    args = (feat, temp, w_rel, lu, lv, rel)
    ref = jax_scenario_agg(*map(_j, args), num_scen=2, mode="interpret", groups=(LR, DIL))
    out = scenario_aggregate(*map(_t, args), 2, (LR, DIL))
    _close(out, ref, rtol=1e-5)


# --- win_edge ---------------------------------------------------------------

def _pair_case(seed, n_edges, sd, ss, nd_win, ns_win, cap, chunk, skip_dst_win=None):
    rng = np.random.RandomState(seed)
    nd, ns = sd * nd_win, ss * ns_win
    u = rng.randint(0, nd, n_edges)
    v = rng.randint(0, ns, n_edges)
    if skip_dst_win is not None:
        keep = (u // sd) != skip_dst_win
        u, v = u[keep], v[keep]
    d, dropped = build_pair_plan(u, v, sd, ss, cap, chunk)
    assert dropped == 0
    idx = np.concatenate([d["lu"], d["lv"]], axis=1)
    meta = np.stack([d[k] for k in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    rows = [r(nd, C), r(nd, C), r(ns, C), r(ns, C), r(nd, C)]  # pd, qd, ps, cs, temp
    weights = [r(C), r(C, C), r(C) + 1.0, r(C), r(C, C), r(C) + 1.0, r(C), r(C, C)]
    return rows, weights, idx, meta


@pytest.mark.parametrize("case", [
    # Destination window 2 is never touched: its rows must stay temp.
    dict(n_edges=300, skip=2, cap=1024),
    # Capacity well past the edges: all-padding tail chunks.
    dict(n_edges=40, skip=None, cap=2048),
    # Empty plan.
    dict(n_edges=0, skip=None, cap=256),
], ids=["untouched-window", "padding-chunks", "empty-plan"])
def test_win_edge_matches_pallas(case):
    sd, ss, chunk = 32, 16, 16
    rows, weights, idx, meta = _pair_case(3, case["n_edges"], sd, ss, 5, 3, case["cap"],
                                          chunk, case["skip"])
    jplan = JPairPlan(idx=_j(idx), meta=_j(meta), chunk=chunk, dst_stride=sd, src_stride=ss)
    ref = jax_win_edge(*map(_j, rows), *map(_j, weights), jplan, True, True,
                       mode="interpret")
    plan = PairPlan(idx=_t(idx), meta=_t(meta), chunk=chunk, dst_stride=sd, src_stride=ss)
    out = win_edge_mlp(*map(_t, rows), *map(_t, weights), plan)
    _close(out, ref, rtol=1e-5)
    if case["skip"] is not None:
        w = case["skip"]
        np.testing.assert_array_equal(out.numpy()[w * sd:(w + 1) * sd],
                                      rows[4][w * sd:(w + 1) * sd])
    if case["n_edges"] == 0:
        np.testing.assert_array_equal(out.numpy(), rows[4])


# --- row_tail ---------------------------------------------------------------

@pytest.mark.parametrize("n", [300, 1024], ids=["ragged-rows", "tile-rows"])
def test_row_tail_matches_pallas(n):
    rng = np.random.RandomState(4)
    x = rng.randn(n, C).astype(np.float32)
    res = rng.randn(n, C).astype(np.float32)
    w = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    g = [(1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
         (1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)]
    ref = jax_row_tail(_j(x), _j(res), _j(w), *map(_j, g), mode="interpret")
    out = fused_row_tail(_t(x), _t(res), _t(w), *map(_t, g))
    _close(out, ref)


# --- wrappers --------------------------------------------------------------

def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor on neither the CPU nor CUDA gets neither version."""
    x = torch.empty(64, C, device="meta")
    w = torch.empty(C, C, device="meta")
    g = torch.empty(C, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_row_tail(x, x, w, g, g, g, g)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_lane_layer(x, x, torch.empty(2, 64, dtype=torch.bool, device="meta"),
                         torch.empty(2, C, C, device="meta"), w, g, g, g, g, (1, -1))
