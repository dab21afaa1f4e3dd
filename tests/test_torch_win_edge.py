"""win_edge in the port: the pair-plan preparation against a numpy
reference, the plain forward (over the plan's slots, in slot order) and
backward (in its fixed destination and source orders) and the public op
against the Pallas kernel and its VJP in interpret mode, the forward
kernel's sum pass emulated on the CPU, one preparation per fusion stage,
and the accumulator layouts the bf16 kernels' register code relies on
(csrc/win_edge.cu, csrc/lane_layer.cu). Small widths and plans; one JAX
import for the file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.graph import PairPlan as JPairPlan
from lanegcn_tpu.ops.pallas_win_edge import win_edge_mlp as jax_win_edge

from lanegcn_tpu_torch.data.packing import build_pair_plan
from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import win_edge

C = 128
REL = 2e-5
CHUNK = 16

# (destination windows x rows, source windows x rows, edges, slot capacity,
# destination window no edge reaches, rows cut off the end of the
# destination and source arrays)
CASES = {
    # 40 edges in 2048 slots: padding in every chunk and whole tail chunks.
    "padding-slots": ((5, 32), (3, 16), 40, 2048, None, (0, 0)),
    # The last destination and source windows run past nd / ns: the edges
    # into those rows are dropped.
    "past-rows": ((5, 32), (3, 16), 300, 1024, None, (10, 5)),
    # Destination window 2 gets no edge: its dPd / dQd rows are zero.
    "untouched-window": ((5, 32), (3, 16), 300, 1024, 2, (0, 0)),
    "empty": ((5, 32), (3, 16), 0, 256, None, (0, 0)),
    # M2A-like: two destination windows, each one run of many chunks.
    "m2a-like": ((2, 32), (6, 64), 600, 1024, None, (0, 0)),
    # Each destination window's edges come from one source window and fill
    # less than a chunk: runs of one chunk.
    "one-chunk-runs": ((5, 32), (5, 16), 50, 1024, None, (0, 0)),
}


def _case(name, seed=21):
    (nwd, sd), (nws, ss), n_edges, cap, skip, (cut_d, cut_s) = CASES[name]
    rng = np.random.RandomState(seed)
    full_d, full_s = nwd * sd, nws * ss
    u = rng.randint(0, full_d, n_edges)
    v = rng.randint(0, full_s, n_edges)
    if name == "one-chunk-runs":
        v = u // sd * ss + v % ss
    if skip is not None:
        keep = u // sd != skip
        u, v = u[keep], v[keep]
    d, dropped = build_pair_plan(u, v, sd, ss, cap, CHUNK)
    assert dropped == 0
    idx = np.concatenate([d["lu"], d["lv"]], axis=1)
    meta = np.stack([d[k] for k in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
    nd, ns = full_d - cut_d, full_s - cut_s
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    arrays = [r(nd, C), r(nd, C), r(ns, C), r(ns, C), r(nd, C),
              r(C), r(C, C), r(C) + 1.0, r(C), r(C, C), r(C) + 1.0, r(C), r(C, C)]
    g = rng.randn(nd, C).astype(np.float32)
    return dict(idx=idx, meta=meta, sd=sd, ss=ss, nd=nd, ns=ns, full=(full_d, full_s),
                arrays=arrays, g=g)


def _plan(c):
    return PairPlan(idx=torch.from_numpy(c["idx"]), meta=torch.from_numpy(c["meta"]),
                    chunk=CHUNK, dst_stride=c["sd"], src_stride=c["ss"])


def _reference_prep(c):
    """prepare_pair in numpy: the valid slots, sorted by destination row
    (slot order within one), and their source-order positions (a stable
    sort of the destination-ordered source rows)."""
    idx, meta, sd, ss, nd, ns = c["idx"], c["meta"], c["sd"], c["ss"], c["nd"], c["ns"]
    edges = []
    for slot in range(idx.shape[0]):
        lu, lv = int(idx[slot, 0]), int(idx[slot, 1])
        ch = slot // CHUNK
        u, v = int(meta[0, ch]) * sd + lu, int(meta[1, ch]) * ss + lv
        if 0 <= lu < sd and 0 <= lv < ss and u < nd and v < ns:
            edges.append((u, slot, v))
    edges.sort()
    e = len(edges)
    slots = idx.shape[0]
    eu = np.full(slots, nd, np.int64)
    ev = np.full(slots, ns, np.int64)
    eu[:e] = [x[0] for x in edges]
    ev[:e] = [x[2] for x in edges]
    sperm = np.argsort(ev, kind="stable")
    spos = np.empty(slots, np.int64)
    spos[sperm] = np.arange(slots)
    return e, eu, ev, spos, ev[sperm]


@pytest.mark.parametrize("name", list(CASES))
def test_prepare_pair_matches_numpy(name):
    c = _case(name)
    prep = win_edge.prepare_pair(_plan(c), c["nd"], c["ns"])
    e, eu, ev, spos, sseg = _reference_prep(c)
    assert int(prep.count) == e
    np.testing.assert_array_equal(prep.eu.numpy(), eu)
    np.testing.assert_array_equal(prep.ev.numpy(), ev)
    np.testing.assert_array_equal(prep.spos.numpy(), spos)
    np.testing.assert_array_equal(prep.dseg.numpy(), eu)
    np.testing.assert_array_equal(prep.sseg.numpy(), sseg)
    assert prep.eu.dtype == prep.ev.dtype == prep.spos.dtype == torch.int32
    assert prep.dseg.dtype == prep.sseg.dtype == torch.int64
    if name == "past-rows":
        assert 0 < e < int((c["idx"][:, 0] >= 0).sum())
    if name == "empty":
        assert e == 0
    if name == "one-chunk-runs":
        assert int(c["meta"][2].sum()) == 5 and int((c["meta"][0] == c["meta"][0, 0]).sum()) == 1


def _jax_reference(c):
    """The Pallas VJP on the same edges: full-window arrays (the rows cut
    off the port's padded with zeros) and the plan's out-of-range slots
    made padding, so that the kernel sees exactly the port's valid edges."""
    full_d, full_s = c["full"]
    nd, ns = c["nd"], c["ns"]
    idx = c["idx"].copy()
    ch = np.arange(idx.shape[0]) // CHUNK
    u = c["meta"][0, ch] * c["sd"] + idx[:, 0]
    v = c["meta"][1, ch] * c["ss"] + idx[:, 1]
    drop = (idx[:, 0] >= 0) & ((u >= nd) | (v >= ns))
    idx[drop] = -1
    pad = lambda a, rows: np.pad(a, ((0, rows - a.shape[0]), (0, 0)))
    a = c["arrays"]
    rows = [pad(a[0], full_d), pad(a[1], full_d), pad(a[2], full_s), pad(a[3], full_s),
            pad(a[4], full_d)]
    jplan = JPairPlan(idx=jnp.asarray(idx), meta=jnp.asarray(c["meta"]), chunk=CHUNK,
                      dst_stride=c["sd"], src_stride=c["ss"])
    out, vjp = jax.vjp(lambda *x: jax_win_edge(*x, jplan, True, True, mode="interpret"),
                       *map(jnp.asarray, rows + a[5:]))
    grads = vjp(jnp.asarray(pad(c["g"], full_d)))
    cut = [nd, nd, ns, ns, nd]
    return (np.asarray(out)[:nd],
            [np.asarray(x)[:cut[i]] if i < 5 else np.asarray(x) for i, x in enumerate(grads)])


def _close(port, ref, what):
    port = port.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = REL * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if ref.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


NAMES = ["pd", "qd", "ps", "cs", "bd", "kdo", "gdow", "gdob", "k1", "gchw", "gchb", "kout"]


@pytest.mark.parametrize("name", list(CASES))
def test_win_edge_bwd_plain_matches_pallas_vjp(name):
    """win_edge_bwd_plain (its fixed destination and source orders) and the
    public op's forward and gradients against the Pallas kernel and its
    VJP in interpret mode."""
    c = _case(name)
    ref_out, ref = _jax_reference(c)
    plan = _plan(c)
    t = [torch.from_numpy(a) for a in c["arrays"]]
    g = torch.from_numpy(c["g"])
    prep = win_edge.prepare_pair(plan, c["nd"], c["ns"])
    _close(win_edge.win_edge_plain(*t, plan), ref_out, f"{name} plain out")
    got = win_edge.win_edge_bwd_plain(*t[:4], *t[5:], plan, g, 1e-5, prep)
    ref_no_temp = ref[:4] + ref[5:]
    for nm, a, b in zip(NAMES, got, ref_no_temp):
        _close(a, b, f"{name} d{nm}")
    # The public op through its autograd Function, with the preparation made
    # by the stage (and without: the backward makes its own).
    for p in (prep, None):
        leaves = [x.clone().requires_grad_(True) for x in t]
        out = win_edge.win_edge_mlp(*leaves, plan, prep=p)
        _close(out, ref_out, f"{name} out")
        out.backward(g)
        for nm, leaf, b in zip(NAMES[:4] + ["temp"] + NAMES[4:], leaves, ref):
            _close(leaf.grad, b, f"{name} d{nm} (op)")
    if name == "untouched-window":
        w = slice(2 * c["sd"], 3 * c["sd"])
        assert not got[0][w].any() and not got[1][w].any()
    if name == "empty":
        assert all(not x.any() for x in got)


SUM_ROWS = 32  # csrc/win_edge.cu: destination rows of a sum-pass item


@pytest.mark.parametrize("name", list(CASES))
def test_forward_sum_pass_emulated_is_bitwise_the_plain_version(name):
    """The forward kernel's sum pass on the CPU: per item (32 rows of one
    destination window), the window's chunks found by searching dwin, their
    slots walked in slot order, each edge's e2 row (written at its slot by
    the chain pass) added into its row from temp. Every row is written by
    exactly one item, and the result is bitwise win_edge_plain's."""
    c = _case(name)
    plan = _plan(c)
    t = [torch.from_numpy(a) for a in c["arrays"]]
    pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout = t
    nd, ns, sd = c["nd"], c["ns"], c["sd"]
    ok, u, v = win_edge._slot_rows(plan, nd, ns)
    # The chain pass: e2 of every valid slot, at the slot (the plain chain).
    uu, vv = torch.where(ok, u, nd), torch.where(ok, v, ns)
    pad = win_edge._pad
    t1 = torch.relu(pad(pd)[uu] + pad(ps)[vv] + bd)
    t2 = torch.relu(win_edge.group_norm(t1 @ kdo, gdow, gdob, 1, 1e-5))
    e1 = torch.relu(win_edge.group_norm(t2 @ k1 + pad(cs)[vv] + pad(qd)[uu], gchw, gchb, 1,
                                        1e-5))
    ws = torch.where(ok[:, None], e1 @ kout, torch.nan)  # slots without an edge are never read
    dwin = plan.dwin
    out = torch.full_like(temp, torch.nan)
    per_win = -(-sd // SUM_ROWS)
    for item in range(-(-nd // sd) * per_win):
        w, r_lo = item // per_win, item % per_win * SUM_ROWS
        g0 = w * sd + r_lo
        rows = min(SUM_ROWS, sd - r_lo, nd - g0)
        if rows <= 0:
            continue
        acc = temp[g0:g0 + rows].clone()
        k0 = int(torch.searchsorted(dwin, w))
        k1_ = int(torch.searchsorted(dwin, w + 1))
        for slot in range(k0 * CHUNK, k1_ * CHUNK):
            if ok[slot] and g0 <= u[slot] < g0 + rows:
                acc[int(u[slot]) - g0] += ws[slot]
        assert torch.isnan(out[g0:g0 + rows]).all()  # each row written once
        out[g0:g0 + rows] = acc
    assert torch.equal(out, win_edge.win_edge_plain(*t, plan))


def test_prepare_pair_makes_no_host_sync():
    """No nonzero and no .item() in the preparation (the train step on the
    card asserts both per step)."""
    from torch.profiler import ProfilerActivity, profile

    c = _case("past-rows")
    plan = _plan(c)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        win_edge.prepare_pair(plan, c["nd"], c["ns"])
    names = {e.name for e in prof.events()}
    assert "aten::nonzero" not in names and "aten::_local_scalar_dense" not in names


def test_one_pair_preparation_per_fusion_stage(monkeypatch):
    """A LaneGCN train forward prepares each fusion stage's pair plan once
    (A2M, M2A, A2A, shared by each stage's two Att layers) and its
    backward uses it; a forward without gradient prepares none."""
    from lanegcn_tpu_torch.config import ModelConfig, windowed_pack_config
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models import fusion
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN

    model = ModelConfig(n_actor=32, n_map=32, num_fuse_layers=1, num_att_layers=2)
    scens = [make_urban_scenario(seed=60 + i, num_corridors=3, num_actors=6) for i in range(2)]
    cfg = dataclasses.replace(windowed_pack_config(2), node_stride=256, max_nodes=512)
    b, st = pack_batch(scens, cfg, model)
    assert st["packed_scenarios"] == 2
    batch = PackedBatch.from_numpy(b)
    assert batch.fusion.pair_a2m is not None
    made, used = [], []
    prep_fn, bwd_fn = fusion.prepare_pair, win_edge.win_edge_bwd_plain

    def counted_prep(*a):
        made.append(prep_fn(*a))
        return made[-1]

    def counted_bwd(*a):
        used.append(a[-1])
        return bwd_fn(*a)

    monkeypatch.setattr(fusion, "prepare_pair", counted_prep)
    monkeypatch.setattr(win_edge, "win_edge_bwd_plain", counted_bwd)
    net = LaneGCN(model, dtype=torch.float32, device="cpu", seed=0)
    with torch.no_grad():
        net(batch)
    assert not made
    out = net(batch)
    assert len(made) == 3
    (out["cls"].sum() + out["reg"].sum()).backward()
    assert len(used) == 6 and all(any(u is m for m in made) for u in used)


# --- the accumulator layouts of the bf16 kernels ------------------------------
#
# wgmma m64n128 leaves element i of thread t (warp w of its warpgroup, lane
# l) at row 16w + l/4 + 8·((i >> 1) & 1), column 8·(i >> 2) + 2·(l % 4) +
# (i & 1) (common.cuh acc_row / acc_col).

def _acc_pos(w, lane, i):
    return 16 * w + lane // 4 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * (lane % 4) + (i & 1)


def test_accumulator_pairs_are_the_register_a_fragment():
    """lane_layer's tail feeds h to z = h @ W2 from the accumulator: register
    q of k slice ks is elements 8ks + 2q, + 1, which must sit where
    ldmatrix puts the A fragment (rows l/4 and l/4 + 8 of the warp's 16,
    columns 16ks + 2(l % 4) (+ 8 for q ≥ 2))."""
    for lane in range(32):
        for ks in range(C // 16):
            for q in range(4):
                i = 8 * ks + 2 * q
                row, col = _acc_pos(0, lane, i)
                assert (row, col) == (lane // 4 + 8 * (q & 1), 16 * ks + 8 * (q >> 1)
                                      + 2 * (lane % 4))
                assert _acc_pos(0, lane, i + 1) == (row, col + 1)


def test_column_sum_butterfly_sums_each_column_once():
    """win_edge's col_sums, emulated: each thread adds its two rows, then
    three halving shuffle stages (masks 16, 8, 4) over the 8 lanes of one
    lane % 4; lane l ends with columns (2g + (j >> 1))·8 + 2q + (j & 1),
    g = l / 4, q = l % 4, j < 4 (the order the kernel writes them in), and
    over the warp's 32 lanes every column is the sum of its 16 rows."""
    rng = np.random.RandomState(5)
    tile = rng.randn(16, C)  # one warp's 16 rows
    x = np.zeros((32, 32))
    for lane in range(32):
        for j in range(32):
            for h in range(2):
                i = 4 * (j >> 1) + (j & 1) + 2 * h
                x[lane, j] += tile[_acc_pos(0, lane, i)]
    half = 16
    for m in (16, 8, 4):
        new = x.copy()
        for lane in range(32):
            hi = bool(lane & m)
            for j in range(half):
                # the partner (its bit m the other way) sends the half this lane keeps
                recv = x[lane ^ m, j + half] if hi else x[lane ^ m, j]
                keep = x[lane, j + half] if hi else x[lane, j]
                new[lane, j] = keep + recv
        x, half = new, half // 2
    got = np.full(C, np.nan)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for j in range(4):
            col = (2 * g + (j >> 1)) * 8 + 2 * q + (j & 1)
            assert np.isnan(got[col])
            got[col] = x[lane, j]
    np.testing.assert_allclose(got, tile.sum(0), rtol=1e-12, atol=1e-12)
