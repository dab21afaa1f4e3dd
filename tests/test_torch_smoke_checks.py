"""chip_smoke.py's excuse for win_edge_bwd's source-side misses (`tie_rows`,
`src_tie`, `edge_chain`), on the CPU at a small size: a source row that
misses only through a near tie is excused, a dropped or doubled edge is
not, and in float32 nothing on the source side is excused. The "kernel"
outputs are the plain version's with a fault or a tie put into one row."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from lanegcn_tpu_torch.data.packing import build_pair_plan
from lanegcn_tpu_torch.graph import PairPlan
from lanegcn_tpu_torch.ops import win_edge

C, CHUNK = 128, 16
SD, SS, NWD, NWS = 32, 64, 5, 3  # windows x rows of the destination and source sides


def _inputs(dtype):
    rng = np.random.RandomState(3)
    u, v = rng.randint(0, NWD * SD, 300), rng.randint(0, NWS * SS, 300)
    lay, dropped = build_pair_plan(u, v, SD, SS, 1024, CHUNK)
    assert dropped == 0
    t = torch.from_numpy
    plan = PairPlan(idx=t(np.concatenate([lay["lu"], lay["lv"]], 1)),
                    meta=t(np.stack([lay[k] for k in ("dwin", "swin", "first", "sperm",
                                                      "sswin", "sfirst")])),
                    chunk=CHUNK, dst_stride=SD, src_stride=SS)
    nd, ns = NWD * SD, NWS * SS
    r = lambda *s: t((rng.randn(*s) * 0.3).astype(np.float32)).to(dtype)
    a = [r(nd, C), r(nd, C), r(ns, C), r(ns, C), r(C), r(C, C), r(C) + 1.0, r(C), r(C, C),
         r(C) + 1.0, r(C), r(C, C), plan, t(rng.randn(nd, C).astype(np.float32)).to(dtype)]
    _, eu, ev = win_edge._edge_rows(plan, nd, ns)
    return a, win_edge.win_edge_bwd_plain(*a), eu, ev


def _with_row(out_p, other, r):
    """The plain outputs with source row r of dPs and dCs taken from `other`."""
    out = [o.clone() for o in out_p]
    out[2][r], out[3][r] = other[2][r], other[3][r]
    return out


def _relu_tie(a, eu, ev):
    """(source row, its one edge's destination row, the plain outputs of
    inputs that flip that edge's s pre-activation nearest zero): the bias
    moves for every edge, by less than any other edge's distance from zero
    at that channel."""
    counts = torch.bincount(ev)
    s_pre = cs.relu_pre("win_edge_bwd", a)[2][0]
    for e in range(eu.shape[0]):
        if counts[ev[e]] == 1:
            c = int(s_pre[e].abs().argmin())
            b = a[10].float().clone()
            b[c] -= 2 * s_pre[e, c]
            flipped = list(a)
            flipped[10] = b
            return int(ev[e]), int(eu[e]), win_edge.win_edge_bwd_plain(*flipped)
    raise AssertionError("no source row with one edge")


def test_clean_outputs_excuse_nothing():
    a, out_p, _, _ = _inputs(torch.bfloat16)
    rows, how = cs.tie_rows("win_edge_bwd", "bfloat16", out_p, out_p, a)
    assert rows.numel() == 0 and how == {}


def test_a_relu_tie_on_a_one_edge_source_row_is_excused():
    a, out_p, eu, ev = _inputs(torch.bfloat16)
    r, dst, out_f = _relu_tie(a, eu, ev)
    rows, how = cs.tie_rows("win_edge_bwd", "bfloat16", _with_row(out_p, out_f, r), out_p, a)
    assert how[r]["vs_plain"] > 1 and how[r]["vs_evaluation"] <= 1
    assert rows.tolist() == [dst]


def test_the_one_edge_evaluation_matches_the_plain_rows():
    a, out_p, eu, ev = _inputs(torch.bfloat16)
    ref = [out_p[i].float() for i in (2, 3)]
    for r in torch.unique(ev)[:40].tolist():
        total = sum(cs.edge_chain(a, int(k), r) for k in eu[ev == r])
        scale = cs.TOL["bfloat16"] * torch.cat([x[r].abs() + x.square().mean().sqrt()
                                                for x in ref])
        assert ((total - torch.cat([x[r] for x in ref])).abs() <= scale).all(), r


@pytest.mark.parametrize("fault", ["dropped", "doubled"])
def test_a_dropped_or_doubled_edge_is_not_excused(fault):
    a, out_p, eu, ev = _inputs(torch.bfloat16)
    for r in torch.unique(ev)[:12].tolist():
        e = int(torch.nonzero(ev == r)[0])
        g = a[13].clone()
        g[eu[e]] = 0 if fault == "dropped" else 2 * g[eu[e]]
        faulty = win_edge.win_edge_bwd_plain(*a[:13], g)
        with pytest.raises(RuntimeError, match=f"source row {r} misses"):
            cs.tie_rows("win_edge_bwd", "bfloat16", _with_row(out_p, faulty, r), out_p, a)


def test_float32_excuses_no_source_row():
    a, out_p, eu, ev = _inputs(torch.float32)
    r, _, out_f = _relu_tie(a, eu, ev)
    rows, how = cs.tie_rows("win_edge_bwd", "float32", _with_row(out_p, out_f, r), out_p, a)
    assert rows.numel() == 0 and how == {}


def test_cut_helpers_make_band_conv_and_row_tail2_bwd_cases():
    """`lane_case_calls` cuts band_conv's largest captured forward call (not
    a smaller one) to LANE_ROWS and to LANE_ZERO_REL_ROWS with relation 0's
    band mask, its argument 1, all zero, and leaves the capture as it was;
    `ragged_calls` cuts row_tail2_bwd's largest captured call to its
    RAGGED_EXTRA_ROWS and to RAGGED_ROWS, x, res and the cotangent with it,
    the weights and the GN vectors as they were."""
    shifts = (-1, 1, -32, 32)
    n, j = 500, len(shifts)
    feat, w = torch.randn(n, C), torch.randn(j, C, C)
    masks = torch.ones(j, n, dtype=torch.bool)
    big = [feat, masks, w, shifts]
    small = cs.cut_rows(big, 300)
    cases, counts = cs.lane_case_calls({cs.shape_key(big): big, cs.shape_key(small): small},
                                       "band_conv")
    assert sorted(a[0].shape[0] for a in cases.values()) == sorted(
        cs.LANE_ROWS + (cs.LANE_ZERO_REL_ROWS,))
    for a in cases.values():
        rows = a[0].shape[0]
        assert torch.equal(a[0], feat[:rows]) and a[1].shape == (j, rows)
        assert a[2] is w and a[3] == shifts
        assert bool(a[1][0].any()) == (rows != cs.LANE_ZERO_REL_ROWS) and bool(a[1][1:].all())
    assert bool(masks.all()) and set(counts.values()) == {0}

    n = 30000
    x, res, g = torch.randn(n, C), torch.randn(n, C), torch.randn(n, C)
    w1, w2 = torch.randn(C, C), torch.randn(C, C)
    gns = [torch.randn(C) for _ in range(6)]
    args = [x, res, w1, w2, *gns, g]
    cut = cs.ragged_calls({"row_tail2_bwd": {cs.shape_key(args): args}})["row_tail2_bwd"]
    want = cs.RAGGED_EXTRA_ROWS["row_tail2_bwd"] + cs.RAGGED_ROWS
    assert sorted(a[0].shape[0] for a in cut.values()) == sorted(want)
    assert {1, 63, 65, 127, 129} <= set(want) and "row_tail2_bwd" in cs.RAGGED_BWD
    for a in cut.values():
        rows = a[0].shape[0]
        assert all(torch.equal(a[i], args[i][:rows]) for i in (0, 1, 10))
        assert all(a[i] is args[i] for i in range(2, 10))


def test_plan_case_helpers_build_lane_plan_arguments():
    """`plan_case_calls(..., layer=True)` builds lane_plan's forward and
    backward arguments on every PLAN_CASES plan (the same plans as
    scenario_agg's cases, with band masks over PLAN_SHIFTS, ±32 among them,
    and the tail's weights): the layout the public op and the backward
    launcher take, the backward's temp the plain forward's fp32 temp, and
    the plain versions run on each (as chip_smoke.py's kernel check calls
    them)."""
    _check_plan_case_helpers(C)


def test_plan_case_helpers_build_lane_plan_arguments_at_64():
    """The same on 64-wide rows, as the half-width merged geometry asks for
    them (`plan_case_calls(..., width=64)`): the same plans, every row,
    weight and GN vector 64 wide."""
    _check_plan_case_helpers(64)


def _check_plan_case_helpers(width):
    from lanegcn_tpu_torch.ops import lane_layer

    assert {-32, 32} <= set(cs.PLAN_SHIFTS)
    c = width
    plans, _, _ = cs.plan_case_calls(False, dev="cpu", width=c)
    fwd, counts, empty = cs.plan_case_calls(False, layer=True, dev="cpu", width=c)
    bwd, _, _ = cs.plan_case_calls(True, layer=True, dev="cpu", width=c)
    assert len(fwd) == len(bwd) == len(plans) == len(cs.PLAN_CASES) and set(counts.values()) == {0}
    assert {a[0].shape[0] // a[13] for a in fwd.values()} == {256, 512, 768, 1024}
    (_, plain_fwd), = cs.forward_ops(["lane_plan"]).values()
    (_, plain_bwd), = cs.backward_ops(["lane_plan"]).values()
    for p, f, b in zip(plans.values(), fwd.values(), bwd.values()):
        n, j = f[0].shape[0], len(cs.PLAN_SHIFTS)
        assert all(torch.equal(x, y) for x, y in zip(p[3:6], f[10:13]))
        assert f[13:] == [p[6], cs.PLAN_SHIFTS, p[7]] and f[2].shape == (j, n)
        assert f[0].shape == (n, c) and all(x.shape == (c,) for x in f[5:9])
        assert f[3].shape == (j, c, c) and f[4].shape == (c, c) and f[9].shape == (14, c, c)
        assert b[14] == f[15] and b[16] == cs.PLAN_SHIFTS and b[1].dtype == torch.float32
        assert torch.equal(b[1], lane_layer._plan_temp_plain(f[0], f[1], f[2], f[3], f[14],
                                                             *f[9:14], f[15]))
        out = plain_fwd(*cs.cast_args(f, torch.float32))
        grads = plain_bwd(*cs.cast_args(b, torch.float32))
        assert out.shape == (n, c) and bool(torch.isfinite(out).all())
        assert len(grads) == 9 and grads[-1].shape == (14, c, c)
    assert empty in fwd


def _edge_call(name, n, rng):
    """A captured call of the flat edge MLP `name` (chip_smoke.py's
    forward_ops / backward_ops layout) with n rows: bf16 rows, fp32 weights
    and vectors, as the model hands them."""
    r = lambda *s: torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32))
    rows = lambda: r(n, C).to(torch.bfloat16)
    gn = [torch.ones(C), torch.zeros(C)]
    if name.startswith("edge_mlp_pool"):
        d, cg, kd = r(n, 4), rows(), r(4, C)
        if name.endswith("_bwd"):
            return [d, cg, kd, r(C), r(C, C), *gn, r(C, C), rows(), 1e-5]
        return [d, None, cg, kd, r(C), None, None, None, r(C, C), *gn, r(C, C), False, False]
    args = [r(n, 2), rows(), rows(), r(2, C), r(C), r(C, C), *gn, r(C, C), *gn, r(C, C)]
    return args + [rows(), 1e-5] if name.endswith("_bwd") else args


@pytest.mark.parametrize("name", ["edge_mlp", "edge_mlp_bwd", "edge_mlp_pool",
                                  "edge_mlp_pool_bwd"])
def test_edge_case_helpers_cover_both_configurations(name, monkeypatch):
    """`add_edge_cases` cuts the largest captured call (not a smaller one)
    of Att's or LanePooling's edge MLP, forward or backward, to EDGE_ROWS
    and adds its all-padding call (EDGE_PAD_ARGS zero: d, cg, Att's qg, the
    cotangent), each at 0 calls a step, the capture's calls left as they
    were; `check_edge_padding` passes the plain version's exact answer and
    fails a kernel whose answer is one element off it."""
    from types import SimpleNamespace

    rng = np.random.RandomState(5)
    big, small = _edge_call(name, 13000, rng), _edge_call(name, 200, rng)
    keys = (cs.shape_key(big), cs.shape_key(small))
    cap = SimpleNamespace(calls={name: dict(zip(keys, (big, small)))},
                          counts={name: dict.fromkeys(keys, 6)})
    pad = cs.add_edge_cases(name, cap)
    added = [a for k, a in cap.calls[name].items() if k not in keys]
    assert sorted(a[0].shape[0] for a in added) == sorted(cs.EDGE_ROWS + (cs.EDGE_PAD_ROWS,))
    assert all(cap.counts[name][cs.shape_key(a)] == 0 for a in added)
    assert all(cap.counts[name][k] == 6 for k in keys) and cap.calls[name][keys[0]] is big
    zeroed = cs.EDGE_PAD_ARGS[name]
    for a in added:
        n = a[0].shape[0]
        for i, (x, y) in enumerate(zip(a, big)):
            if not isinstance(y, torch.Tensor) or y.shape[0] != 13000:
                assert x is y
            elif a is pad and i in zeroed:
                assert x.shape == y[:n].shape and not bool(x.any())
            else:
                assert torch.equal(x, y[:n])

    base = name[:-len("_bwd")] if name.endswith("_bwd") else name
    plain = (cs.backward_ops if name.endswith("_bwd") else cs.forward_ops)([base])[name][1]
    ops = lambda kernel: {name: (kernel, plain)}
    which = "backward_ops" if name.endswith("_bwd") else "forward_ops"
    monkeypatch.setattr(cs, which, lambda names: ops(plain))
    cs.check_edge_padding("cpu", name, pad)

    def off(*a):
        out = plain(*a)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        outs[-1] = outs[-1].clone()
        outs[-1].view(-1)[-1] += 1
        return outs if isinstance(out, (tuple, list)) else outs[0]

    monkeypatch.setattr(cs, which, lambda names: ops(off))
    with pytest.raises(RuntimeError, match="all-padding"):
        cs.check_edge_padding("cpu", name, pad)


@pytest.mark.parametrize("backward", [False, True])
def test_scatter_cases_are_what_their_names_say(backward):
    """SCATTER_CASES as `scatter_case_calls` builds them (on the CPU), each
    against its name: the forward's (msg, temp, lu, wchunk, stride) or the
    backward's (g, lu, wchunk, stride) layout at 128 channels, and the edge
    property the case exists for."""
    _check_scatter_cases(backward, C)


@pytest.mark.parametrize("backward", [False, True])
def test_scatter_cases_at_64_are_what_their_names_say(backward):
    """The same at 64 channels (`scatter_case_calls(width=64)`, the
    half_lanercnn geometry's)."""
    _check_scatter_cases(backward, 64)


def _check_scatter_cases(backward, width):
    from lanegcn_tpu_torch.ops.window_scatter import WCHUNK, flat_destinations

    calls, counts, empty = cs.scatter_case_calls(backward=backward, dev="cpu", width=width)
    assert len(calls) == len(cs.SCATTER_CASES) and not any(counts.values())
    blocks = cs.SCATTER_BLOCKS
    for (name, num_win, stride, cap, _), (key, a) in zip(cs.SCATTER_CASES, calls.items()):
        n = num_win * stride
        lu, wchunk = a[-3], a[-2]
        assert a[-1] == stride and a[-4].shape == (n, width) and lu.shape == (cap, 1)
        if not backward:
            assert a[0].shape == (cap, width) and a[0].dtype == torch.bfloat16
        assert bool((wchunk[1:] >= wchunk[:-1]).all())
        dst = flat_destinations(lu, wchunk, stride, n)
        valid = dst < n
        runs = torch.bincount(dst[valid], minlength=n)
        if name == "empty":
            assert key == empty and not bool(valid.any())
            continue
        assert bool(valid.any())
        if name == "untouched-window":
            assert len(set(range(num_win)) - set((dst[valid] // stride).tolist())) == 1
        elif name == "padding-chunks":
            assert not bool((lu.view(-1, WCHUNK) >= 0).any(1)[-2:].any())
        elif name == "long-run":
            slots = torch.nonzero(dst == int(runs.argmax())).view(-1)
            assert int(slots[-1]) // WCHUNK - int(slots[0]) // WCHUNK >= 2  # 3+ chunks
        elif name == "across-blocks":
            big = blocks["ROWS_BIG"]
            assert n >= blocks["BIG_FROM"]
            b = torch.arange(big, n, big)  # block boundaries: rows b - 1 and b
            both = (runs[b - 1] > 0) & (runs[b] > 0)
            assert int(both.sum()) >= 10
        elif name == "stride-200":
            assert stride % blocks["ROWS_BIG"] and n >= blocks["BIG_FROM"]


def test_narrow_refused_is_the_first_width_checked_kernel(monkeypatch):
    """A LaneRCNN train step's kernel calls in order (the model's wrappers and
    the segment sum, on the CPU, at the half_lanercnn geometry's `refused`
    width): the first call not of ANY_WIDTH's kernels is NARROW_REFUSED's
    kernel, whose check refuses that width, so on the card the step stops
    there with nothing but the segment sum launched."""
    import dataclasses

    from lanegcn_tpu_torch.graph import RoiPackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import scenario_agg, segment_sum
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    spec = cs.GEOMETRIES["half_lanercnn"]
    cfg = cs.pack_config("half_lanercnn", 2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **spec["refused"]))
    packs, _, _, _ = cs.make_packs(cfg, 1, 2, seed0=0, roi=True)
    bundle = get_model("lanercnn", cfg, device="cpu", seed=0)
    net, state = init_state(bundle.config, net=bundle.net, device="cpu")
    step = make_train_step(bundle.config, net, state, device="cpu", loss_fn=bundle.loss_fn,
                           metrics_fn=bundle.metrics_fn)
    order = []
    targets = cs.forward_capture().targets + [(segment_sum, "sorted_segment_sum", "segment_sum")]
    for mod, attr, name in targets:
        fn = getattr(mod, attr)
        monkeypatch.setattr(mod, attr,
                            lambda *a, _fn=fn, _n=name, **k: (order.append(_n), _fn(*a, **k))[1])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step(RoiPackedBatch.from_numpy(packs[0]), 0.0)
    finally:
        torch.set_num_threads(n)
    first = next(k for k in order if k not in cs.ANY_WIDTH)
    assert [first] == list(cs.NARROW_REFUSED) and order.index(first) > 0
    width = spec["refused"]["n_map"]
    x = torch.zeros(512, width)
    with pytest.raises(ValueError, match=rf"^{first}: .*not {width}"):
        scenario_agg._fwd_cuda(x, x, torch.zeros(14, width, width),
                               *[torch.zeros(512, 1, dtype=torch.int32)] * 3, 1, None)


def test_mesh_union_order_lays_out_the_columns_as_the_step_gathers_them():
    """The mesh phase's reference pack holds the group in the order the
    windowed step's gathers lay it out: column 0's scenarios, then column
    1's, each column the balanced split's part in the group's order."""
    from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario
    from lanegcn_tpu_torch.parallel.windowed_parallel import GraphSplit, split_group

    scens = [make_synthetic_scenario(seed=80 + i, num_corridors=1 + i % 3, num_actors=4)
             for i in range(6)]
    for g in (2, 3):
        cols, union = cs.mesh_union_order(scens, g)
        assert [len(c) for c in cols] == [6 // g] * g
        assert union == [s for c in cols for s in c]
        assert sorted(map(id, union)) == sorted(map(id, scens))
        for part, col in enumerate(cols):  # what the loader of column `part` packs
            assert split_group(scens, GraphSplit(part, g, None)) == col
            assert col == [s for s in scens if any(s is c for c in col)]  # group order


def test_mesh_errors_scale_by_the_reference_rms():
    """mesh_errors: the elementwise error over MESH_TOL · (rms + |ref|) and
    the RMS error over MESH_RMS_TOL · rms; a reorder-sized error passes, a
    gradient off by a factor of 2 (a rank's gradient counted twice) fails
    both, and eps widens only the elementwise bound."""
    gen = torch.Generator().manual_seed(0)
    ref = torch.randn(10_000, generator=gen) * torch.rand(10_000, generator=gen) ** 4
    rms = float(ref.square().mean().sqrt())
    noise = torch.randn(10_000, generator=gen)
    worst, rel = cs.mesh_errors(ref + 1e-7 * rms * noise, ref)
    assert worst < 0.01 and rel < 0.01
    worst, rel = cs.mesh_errors(2 * ref, ref)
    assert worst > 1 and rel > 1
    # One element off by twice its bound: the elementwise check alone fails.
    bad = ref.clone()
    bad[7] += 2 * cs.MESH_TOL * (rms + abs(float(ref[7])))
    worst, rel = cs.mesh_errors(bad, ref)
    assert 1.9 < worst < 2.1 and rel < 1
    eps = torch.full_like(ref, 10 * cs.MESH_TOL * rms)
    assert cs.mesh_errors(bad, ref, eps)[0] < 1


def test_relu_flips_are_near_zero_inputs_that_change_side():
    """relu_recorder keeps each torch.relu / F.relu input's elements within
    TIE_EPS["float32"] of zero (once a call), and relu_flips names those that
    a second run puts on the other side; an element far from zero that
    changes side, or one at zero in both runs, is no tie."""
    x1 = torch.tensor([1.0, -3e-7, 0.5, -2.0, 0.0])
    x2 = torch.tensor([1.0, 2e-7, 0.5, 2.0, 0.0])
    first = cs.relu_recorder()
    with first:
        torch.relu(x1)
        torch.nn.functional.relu(2 * x1)
    assert [c[0].tolist() for c in first.calls] == [[1, 4], [1, 4]]
    same = cs.relu_recorder(first.calls)
    with same:
        torch.relu(x1)
        torch.nn.functional.relu(2 * x1)
    assert cs.relu_flips(first.calls, same.calls) == []
    moved = cs.relu_recorder(first.calls)
    with moved:
        torch.relu(x2)
        torch.nn.functional.relu(2 * x2)
    flips = cs.relu_flips(first.calls, moved.calls)
    assert [(k, i) for k, i, _, _ in flips] == [(0, 1), (1, 1)]
    assert flips[0][2] < 0 < flips[0][3]


def test_relu_recorder_follows_a_train_step():
    """train_parity's CPU steps under relu_recorder: the step's ReLU calls
    (forward and the plain backwards) are recorded in one order, a rerun
    from the same parameters flips nothing, and a step from parameters moved
    by TIE_PERTURB makes the same calls."""
    from lanegcn_tpu_torch.config import Config, ModelConfig, contiguous_pack_config
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    cfg = Config(model=ModelConfig(n_actor=16, n_map=32, num_fuse_layers=2, num_att_layers=2),
                 pack=contiguous_pack_config(2))
    scens = [make_synthetic_scenario(seed=i, num_corridors=1, num_actors=4) for i in range(2)]
    batch = PackedBatch.from_numpy(pack_batch(scens, cfg.pack, cfg.model)[0])
    start = LaneGCN(cfg.model, device="cpu", seed=0).state_dict()

    def step(perturb, near=None):
        net = LaneGCN(cfg.model, device="cpu", seed=0)
        net.load_state_dict(start)
        if perturb:
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(1 + cs.TIE_PERTURB * torch.randn(p.shape, generator=gen))
        net, state = init_state(cfg, net=net, device="cpu")
        rec = cs.relu_recorder(near)
        with rec:
            make_train_step(cfg, net, state, device="cpu")(batch, 0.0)
        return rec.calls

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        near = step(False)
        again = step(False, near)
        moved = step(True, near)
    finally:
        torch.set_num_threads(n)
    assert len(near) > 20 and len(again) == len(near) == len(moved)
    assert cs.relu_flips(near, again) == []


@pytest.mark.parametrize("name,shapes,width", [
    ("row_tail", [(9, 64), (9, 64)], 64),
    ("row_tail_bwd", [(9, 128), (9, 128)], 128),
    ("edge_mlp", [(9, 2), (9, 64), (9, 64)], 64),
    ("edge_mlp_bwd", [(9, 2), (9, 128), (9, 128)], 128),
    ("lane_layer", [(9, 128), (9, 6)], 128),
    ("lane_layer", [(9, 64), (12, 9)], 64),
    ("scenario_agg", [(9, 64), (9, 64), (3, 64, 64)], 64),
    ("pair_agg", [(9, 64), (9, 64), (3, 64, 64)], 64),
    ("win_edge", [(9, 64), (9, 64), (5, 64)], 64),
    ("band_conv", [(9, 64), (12, 9), (12, 64, 64)], 64),
    ("band_conv_bwd", [(9, 64), (12, 9), (12, 64, 64), (9, 64)], 64),
    ("lane_plan", [(9, 64), (9, 64), (12, 9), (12, 64, 64)], 64),
    ("lane_plan_bwd", [(9, 128), (9, 128), (12, 9), (12, 128, 128)], 128),
    ("window_scatter", [(512, 64), (256, 64), (512, 1), (1,)], 64),
    ("window_scatter_bwd", [(256, 128), (512, 1), (1,)], 128),
    ("row_tail2", [(9, 64), (9, 64), (64, 64)], 64),
    ("row_tail2_bwd", [(9, 64), (9, 64), (64, 64)], 64),
    ("edge_mlp_pool", [(9, 4), (1,), (9, 64), (4, 64)], 64),
    ("edge_mlp_pool_bwd", [(9, 4), (9, 64), (4, 64)], 64),
])
def test_call_width_reads_the_rows_argument(name, shapes, width):
    """call_width takes the width from the argument ROWS_ARG names (d's 2
    columns and a mask's 6 are never the width)."""
    assert cs.call_width(name, [torch.zeros(s) for s in shapes]) == width


GEOMETRIES_ROI = {g: spec["model"] == "lanercnn" for g, spec in cs.GEOMETRIES.items()}


@pytest.mark.parametrize("geom,before", [
    ("bench", "windowed"), ("half", "bench"), ("lanercnn", "lanercnn")])
def test_reused_scenarios_pack_as_fresh_ones(geom, before, monkeypatch):
    """make_packs through a ScenarioCache that another geometry's packing
    has used gives the packs, stats and per-scenario blobs of fresh
    scenarios; the cache keeps its scenarios as they were made."""
    s, roi = 2, GEOMETRIES_ROI[geom]
    monkeypatch.setattr(cs, "SCENARIOS", cs.ScenarioCache())
    fresh = cs.make_packs(cs.pack_config(geom, s), 1, s, seed0=0, roi=roi,
                          pack_kw=cs.pack_kwargs(geom))
    monkeypatch.setattr(cs, "SCENARIOS", cs.ScenarioCache())
    cs.make_packs(cs.pack_config(before, s), 1, s, seed0=0, roi=GEOMETRIES_ROI[before],
                  pack_kw=cs.pack_kwargs(before))
    assert all(not any(k.startswith("_") for k in scen) for scen in cs.SCENARIOS.made.values())
    reused = cs.make_packs(cs.pack_config(geom, s), 1, s, seed0=0, roi=roi,
                           pack_kw=cs.pack_kwargs(geom))
    assert cs.tree_equal(reused[0], fresh[0]) and reused[1] == fresh[1]

