"""The port's window-plan aggregation (ops/scenario_agg.py) as its kernels
run it: the plan preparation (`prepare_plan`: the applied edges in relation
order, their single-relation 64-edge tiles, destination and source
positions) against a numpy reference of the same plan; the plain forward
and backward against the JAX package's `scenario_aggregate` (the Pallas
kernel in interpret mode, as the JAX tests run it on the CPU) and its VJP;
and a CPU emulation of the kernels' two passes (messages written at their
positions, then the fixed-order segment sum; the dW pass's per-block
partials and their reduction) against the plain versions.

Inputs come from numpy seeds; everything is float32. The emulated forward
and dfeat are bitwise equal to the plain versions: the same fp32 messages,
added to each row in the same order. Tolerances against JAX: 2e-5 of
max(1, max |reference|) (the Pallas kernel sums the same fp32 products
through one-hot matmuls per 512-slot chunk, in another order; a row takes
up to 300 messages here, so its reorder error stays below 1e-5 of the
largest output).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.ops.pallas_scenario_agg import scenario_aggregate as jax_scenario_agg

from lanegcn_tpu_torch.config import ModelConfig, windowed_pack_config
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models import map_net
from lanegcn_tpu_torch.models.layers import init_parameters
from lanegcn_tpu_torch.ops import scenario_agg
from lanegcn_tpu_torch.ops.segment_sum import segment_sum_plain

C = 128
R = 14
LR, DIL = (12, 13), tuple(range(12))
REL = 2e-5
TILE = scenario_agg.TILE


def _grouped(rng, lu, lv, rel, w, stride, k_lr, k_dil):
    """Window w: k_lr left/right edges, then (from the next 512-slot chunk)
    k_dil dilated ones sorted by relation, as the packer lays them out."""
    lu[w, :k_lr] = rng.randint(0, stride, k_lr)
    lv[w, :k_lr] = rng.randint(0, stride, k_lr)
    rel[w, :k_lr] = rng.choice(LR, k_lr)
    o = -(-k_lr // 512) * 512
    lu[w, o:o + k_dil] = rng.randint(0, stride, k_dil)
    lv[w, o:o + k_dil] = rng.randint(0, stride, k_dil)
    rel[w, o:o + k_dil] = np.sort(rng.choice(DIL, k_dil))


def _runs(rng, lu, lv, rel, w, stride, runs, hot=None):
    """Window w: relation runs {relation: edges}, in relation order; `hot`
    sends every edge of the window to that destination row."""
    o = 0
    for r, k in runs.items():
        lu[w, o:o + k] = rng.randint(0, stride, k) if hot is None else hot
        lv[w, o:o + k] = rng.randint(0, stride, k)
        rel[w, o:o + k] = r
        o += k


def _case(name):
    """(lu, lv, rel as [W*ECAP, 1] int32, num_win, stride, groups)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    num_win, stride, ecap, groups = 2, 256, 1024, (LR, DIL)
    if name in ("ungrouped", "runs-63-64-65-129", "hot-row"):
        groups = None
    if name == "full-window":
        ecap, stride = 2048, 512
    if name == "ungrouped":
        num_win = 3
    lu = np.full((num_win, ecap), -1, np.int32)
    lv, rel = lu.copy(), lu.copy()
    if name == "grouped":  # window 1 holds only padding
        _grouped(rng, lu, lv, rel, 0, stride, 300, 500)
    elif name == "ungrouped":
        for w, k in enumerate((700, 33, 0)):
            lu[w, :k] = rng.randint(0, stride, k)
            lv[w, :k] = rng.randint(0, stride, k)
            rel[w, :k] = rng.randint(0, R, k)
    elif name == "unaligned-drops":
        _grouped(rng, lu, lv, rel, 0, stride, 200, 300)
        _grouped(rng, lu, lv, rel, 1, stride, 40, 50)
        rel[0, 5] = 3  # a dilated relation inside the left/right chunk: dropped
        rel[1, 530] = 12  # a left/right relation inside the dilated chunk: dropped
    elif name == "full-window":  # window 0 applies all 2048 slots
        _grouped(rng, lu, lv, rel, 0, stride, 1024, 1024)
        _grouped(rng, lu, lv, rel, 1, stride, 100, 200)
    elif name == "runs-63-64-65-129":  # runs that end inside, at and past a tile
        _runs(rng, lu, lv, rel, 0, stride, {0: 63, 1: 64, 2: 65, 3: 129})
        _runs(rng, lu, lv, rel, 1, stride, {5: 1, 13: 200})
    elif name == "hot-row":  # 300 edges into one destination row
        _runs(rng, lu, lv, rel, 0, stride, {2: 100, 7: 150, 12: 50}, hot=7)
        _runs(rng, lu, lv, rel, 1, stride, {4: 80})
    return tuple(a.reshape(-1, 1) for a in (lu, lv, rel)), num_win, stride, groups


CASES = ["grouped", "ungrouped", "unaligned-drops", "empty", "full-window",
         "runs-63-64-65-129", "hot-row"]


def _arrays(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, C).astype(np.float32), rng.randn(n, C).astype(np.float32),
            (rng.randn(R, C, C) / np.sqrt(C)).astype(np.float32)], rng.randn(n, C).astype(
                np.float32)


def _close(port, ref, what):
    port = port.detach().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = REL * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


# --- the plan preparation ------------------------------------------------------

def _reference_prep(lu, lv, rel, num_win, stride, groups):
    """The kernels' plan in numpy, slot by slot: the applied rule (valid,
    both rows in the window, inside a visited chunk of the slot's relation
    group), the stable relation order, the tiles, and the stable
    destination and source orders."""
    lu, lv, rel = lu[:, 0], lv[:, 0], rel[:, 0]
    ecap = lu.shape[0] // num_win
    grps = [tuple(range(R))] if groups is None else [tuple(g) for g in groups]
    ok = np.zeros(lu.shape[0], bool)
    for w in range(num_win):
        sl = slice(w * ecap, (w + 1) * ecap)
        valid = lu[sl] >= 0
        ends, total = [], 0
        for g in grps:
            m = valid if len(grps) == 1 else valid & np.isin(rel[sl], g)
            total += -(-int(m.sum()) // 512)
            ends.append(total)
        for s in range(ecap):
            gi = next((i for i, e in enumerate(ends) if s // 512 < e), None)
            e = w * ecap + s
            ok[e] = (gi is not None and valid[s] and rel[e] in grps[gi]
                     and lu[e] < stride and 0 <= lv[e] < stride)
    base = np.repeat(np.arange(num_win), ecap) * stride
    key = np.where(ok, rel, R)
    order = np.argsort(key, kind="stable")[: int(ok.sum())]
    u, v = (base + lu)[order], (base + lv)[order]
    counts = np.bincount(key[order], minlength=R)
    starts = np.concatenate([[0], np.cumsum(counts)])
    tiles = [(r, starts[r] + j, min(TILE, counts[r] - j))
             for r in range(R) for j in range(0, counts[r], TILE)]
    ntiles = np.concatenate([[0], np.cumsum(-(-counts // TILE))])
    dperm, sperm = np.argsort(u, kind="stable"), np.argsort(v, kind="stable")
    dpos, spos = np.empty_like(dperm), np.empty_like(sperm)
    dpos[dperm], spos[sperm] = np.arange(len(u)), np.arange(len(u))
    return dict(u=u, v=v, rel_edges=starts, rel_tiles=ntiles, tiles=np.array(tiles).reshape(-1, 3),
                dpos=dpos, dseg=u[dperm], spos=spos, sseg=v[sperm])


@pytest.mark.parametrize("name", CASES)
def test_prepare_plan_matches_numpy_reference(name):
    plan, num_win, stride, groups = _case(name)
    ref = _reference_prep(*plan, num_win, stride, groups)
    p = scenario_agg.prepare_plan(*map(torch.from_numpy, plan), num_win, stride, groups, R)
    n, slots, e = num_win * stride, plan[0].shape[0], len(ref["u"])
    np.testing.assert_array_equal(p.dst[:e].numpy(), ref["u"])
    np.testing.assert_array_equal(p.src[:e].numpy(), ref["v"])
    assert (p.dst[e:] == n).all() and (p.src[e:] == n).all()
    np.testing.assert_array_equal(p.rel_edges.numpy(), ref["rel_edges"])
    np.testing.assert_array_equal(p.rel_tiles.numpy(), ref["rel_tiles"])
    # The table: one relation per tile, the live tiles first, its length
    # bounded on the host, the spare entries marked past the end.
    t = len(ref["tiles"])
    assert p.tiles.shape == (-(-slots // TILE) + R, 3)
    np.testing.assert_array_equal(p.tiles[:t].numpy(), ref["tiles"])
    assert (p.tiles[t:, 0] == -1).all() and (p.tiles[t:, 1:] == 0).all()
    for k in ("dpos", "spos"):
        np.testing.assert_array_equal(getattr(p, k)[:e].numpy(), ref[k], err_msg=k)
    for k in ("dseg", "sseg"):
        np.testing.assert_array_equal(getattr(p, k)[:e].numpy(), ref[k], err_msg=k)
        assert (getattr(p, k)[e:] == n).all()
    if name == "empty":
        assert e == 0 and t == 0
    if name == "full-window":
        assert e == 2048 + 300
    if name == "unaligned-drops":
        assert e == 200 + 300 + 40 + 50 - 2
    if name == "runs-63-64-65-129":
        np.testing.assert_array_equal(ref["tiles"][:7, 2], [63, 64, 64, 1, 64, 64, 1])
    without = scenario_agg.prepare_plan(*map(torch.from_numpy, plan), num_win, stride, groups, R,
                                        backward=False)
    assert without.spos is None and without.sseg is None
    for a, b in zip(without[:7], p[:7]):
        assert torch.equal(a, b)


# --- the plain versions against the JAX kernel -----------------------------------

@pytest.mark.parametrize("name", CASES)
def test_plain_forward_and_vjp_match_pallas(name):
    plan, num_win, stride, groups = _case(name)
    arrays, g = _arrays(5, num_win * stride)
    jplan = [jnp.asarray(a) for a in plan]

    def jfn(feat, temp, w_rel):
        return jax_scenario_agg(feat, temp, w_rel, *jplan, num_scen=num_win, mode="interpret",
                                groups=groups)

    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    ref_grads = vjp(jnp.asarray(g))
    tplan = tuple(map(torch.from_numpy, plan))
    prep = scenario_agg.prepare_plan(*tplan, num_win, stride, groups, R)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = scenario_agg.scenario_aggregate(*leaves, *tplan, num_win, groups, prep)
    _close(out, ref, f"{name} out")
    out.backward(torch.from_numpy(g))
    for nm, t, want in zip(("feat", "temp", "w_rel"), leaves, ref_grads):
        _close(t.grad, want, f"{name} d{nm}")
    if name == "empty":
        np.testing.assert_array_equal(out.detach().numpy(), arrays[1])
        assert not leaves[0].grad.any() and not leaves[2].grad.any()


# --- the kernels' two passes, emulated on the CPU ----------------------------------

def _counts(prep):
    return (prep.rel_edges[1:] - prep.rel_edges[:-1]).tolist()


@pytest.mark.parametrize("name", CASES)
def test_two_pass_emulation_is_bitwise_the_plain_version(name):
    """Pass 1 writes each edge's fp32 message at its destination position;
    pass 2 is the segment sum from temp: bitwise scenario_agg_plain. The
    backward's dfeat likewise, at the source positions, from zero."""
    plan, num_win, stride, groups = _case(name)
    arrays, g = _arrays(6, num_win * stride)
    feat, temp, w_rel = map(torch.from_numpy, arrays)
    g = torch.from_numpy(g)
    tplan = tuple(map(torch.from_numpy, plan))
    n, slots = feat.shape[0], plan[0].shape[0]
    p = scenario_agg.prepare_plan(*tplan, num_win, stride, groups, R)
    e = int(p.rel_edges[-1])
    dst, src = p.dst[:e].long(), p.src[:e].long()

    ws = torch.zeros(slots, C)
    ws[p.dpos[:e].long()] = scenario_agg._per_relation(feat[src], w_rel, _counts(p))
    out = segment_sum_plain(ws, p.dseg, n, out=temp)
    assert torch.equal(out, scenario_agg.scenario_agg_plain(feat, temp, w_rel, *tplan, num_win,
                                                            groups))

    ws = torch.zeros(slots, C)
    ws[p.spos[:e].long()] = scenario_agg._per_relation(g[dst], w_rel, _counts(p), transpose=True)
    dfeat = segment_sum_plain(ws, p.sseg, n)
    plain_dfeat, plain_dw = scenario_agg.scenario_agg_bwd_plain(feat, w_rel, *tplan, num_win,
                                                                groups, g)
    assert torch.equal(dfeat, plain_dfeat)


def _block_runs(rel_tiles, tiles, blocks):
    """The dW pass's (block, relation, tiles) runs: block b walks tiles
    [b*T/B, (b+1)*T/B) and flushes a partial on every change of relation."""
    total = int(rel_tiles[-1])
    runs = []
    for b in range(blocks):
        lo, hi = b * total // blocks, (b + 1) * total // blocks
        for t in range(lo, hi):
            r = int(tiles[t, 0])
            if not runs or runs[-1][:2] != (b, r):
                runs.append((b, r, []))
            runs[-1][2].append(t)
    return runs


@pytest.mark.parametrize("blocks", [1, 3, 7, 264])
@pytest.mark.parametrize("name", ["grouped", "full-window", "runs-63-64-65-129", "empty"])
def test_dw_partials_emulation_matches_the_plain_version(name, blocks):
    """Each (block, relation) run of the dW pass owns partial slot b + r
    (no two runs share one), and the reduction's rule (the blocks whose
    tiles meet relation r's, in block order) picks exactly relation r's
    runs: their sum is the plain dW_rel."""
    plan, num_win, stride, groups = _case(name)
    arrays, g = _arrays(7, num_win * stride)
    feat, _, w_rel = map(torch.from_numpy, arrays)
    g = torch.from_numpy(g)
    tplan = tuple(map(torch.from_numpy, plan))
    p = scenario_agg.prepare_plan(*tplan, num_win, stride, groups, R)
    runs = _block_runs(p.rel_tiles, p.tiles, blocks)
    slots = [b + r for b, r, _ in runs]
    assert len(set(slots)) == len(slots) and max(slots, default=0) < blocks + R
    part = {}
    for b, r, ts in runs:
        acc = torch.zeros(C, C)
        for t in ts:
            _, first, cnt = p.tiles[t].tolist()
            rows = slice(first, first + cnt)
            acc += feat[p.src[rows].long()].t() @ g[p.dst[rows].long()]
        part[b + r] = acc
    total = int(p.rel_tiles[-1])
    dw = torch.zeros(R, C, C)
    for r in range(R):
        ts, te = int(p.rel_tiles[r]), int(p.rel_tiles[r + 1])
        spans = [(b * total // blocks, (b + 1) * total // blocks) for b in range(blocks)]
        picked = [b for b, (lo, hi) in enumerate(spans) if ts < te and lo < hi and lo < te and hi > ts]
        assert picked == [b for b, rr, _ in runs if rr == r]
        for b in picked:
            dw[r] += part[b + r]
    _, plain_dw = scenario_agg.scenario_agg_bwd_plain(feat, w_rel, *tplan, num_win, groups, g)
    _close(dw, plain_dw.numpy(), f"{name} dW_rel, {blocks} blocks")


# --- the LaneConv stack prepares the plan once a call ----------------------------

MODEL = ModelConfig(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=1)


def test_stack_prepares_the_plan_once_per_call(monkeypatch):
    """One prepare_plan per LaneConvStack call, with the source order only
    when a gradient is wanted, and every layer's scenario_aggregate gets it."""
    scens = [make_urban_scenario(seed=40 + i, num_corridors=3, num_actors=6) for i in range(2)]
    b, st = pack_batch(scens, windowed_pack_config(2), MODEL)
    assert st["plan_edges"] > 0
    graph = PackedBatch.from_numpy(b).graph
    stack = map_net.LaneConvStack(dataclasses.replace(MODEL, merge_plan_agg="off"), 2)
    init_parameters(stack, seed=0)
    made, seen = [], []
    prepare, aggregate = map_net.prepare_plan, map_net.scenario_aggregate

    def counted_prepare(*a, **k):
        made.append(prepare(*a, **k))
        return made[-1]

    def counted_aggregate(*a):
        seen.append(a[-1])
        return aggregate(*a)

    monkeypatch.setattr(map_net, "prepare_plan", counted_prepare)
    monkeypatch.setattr(map_net, "scenario_aggregate", counted_aggregate)
    feat = torch.randn(graph.capacity, 32, requires_grad=True)
    out = stack(feat, **map_net.graph_inputs(graph))
    out.square().mean().backward()
    assert len(made) == 1 and made[0].spos is not None
    assert len(seen) == 2 and all(s is made[0] for s in seen)
    with torch.no_grad():
        stack(feat, **map_net.graph_inputs(graph))
    assert len(made) == 2 and made[1].spos is None
