#!/usr/bin/env python3
"""Time two builds of the port's CUDA kernels against each other on one GPU.

    git archive <commit> | tar -x -C build/ab_old     # the other tree
    python3 chip_ab.py build/ab_old [kernel ...]       # default: every target

For each named kernel library, the sources of this checkout ("new") and of
the other tree ("old", where it has that kernel) are built side by side
with the same nvcc flags. Both run through this checkout's wrappers where
the C interfaces match, on the same inputs, captured from one bf16 eval
forward and one bf16 train step of the geometry that runs the kernel:
win_edge and lane_layer on windowed_pack_config(256), pair_agg on
bench_pack_config(256) (the spill plan), edge_mlp on
contiguous_pack_config(32) (Att's flags) and on LaneRCNN's geometry
(LanePooling's, `edge_mlp_pool`; the backward with dd, as chip_smoke.py
checks it), lane_plan on the merged geometry and band_conv
on the unfused one (chip_smoke.py GEOMETRIES); segment_sum on every call
shape of one bf16 train step (the scatters' forwards and the gathers'
backwards) of the windowed, LaneRCNN and flat geometries; scenario_agg
and its backward on the windowed and LaneRCNN geometries, the other tree
through its own wrappers (`OWN_WRAPPERS`: the C interfaces differ), with
the time of this checkout's plan preparation beside (`new_prep_ms`); the
lane_plan forward and backward likewise (the other tree's ops/lane_layer.py
loaded with that tree's ops/scenario_agg.py, `WRAPPER_MODULES`,
`OLD_IMPORTS`; this checkout's calls handed the preparation the model
made, its time beside); the win_edge forward and backward likewise (their
C interfaces changed: the other tree's through its own wrappers, and for
the backward this checkout's pair-plan preparation timed beside,
`new_prep_ms`, the call itself handed the preparation the train step made, as a fusion stage hands
it to its Att layers); the pair_agg forward and backward likewise (the
spill plan's `prepare_spill` timed beside, forward-only for the forward,
the call handed the one a LaneGCN forward made); row_tail's forward and
backward at K = 1 on the windowed geometry (Att's tails) and at K = 2 on
LaneRCNN's (LanePooling's tail, `row_tail2`; the K = 2 backward's C
interface changed: the other tree's through its own wrapper; so did the K
= 1 forward's and backward's, which took the row width); Att's edge_mlp
forward and backward likewise (the backward's C interface took the bf16
workspace `act` and the weight-gradient pass's splits, both then the row
width); the lane_layer forward and backward likewise (their C interfaces
took the row width, as the scenario_agg, pair_agg and win_edge forwards'
and then backwards' did, and then band_conv's and lane_plan's both ways);
window_scatter and its backward on
LaneRCNN's geometry (both pool scatters, r2g and g2r; their C interfaces
took the row width, as row_tail2's and LanePooling's edge_mlp's both ways
did: the other tree's through its own wrappers). lane_layer, row_tail and
edge_mlp also run at W = 64 (`half`; `widths`, Att's tails and A2A's edge
MLP at 64 beside A2M's at 128; `half_lanercnn`, LanePooling's tail and
edge MLP), and lane_layer and row_tail also on `contiguous` (the
128-wide shapes of the CLI's layout, whose 256-wide model has kernels of
its own). window_scatter, row_tail, edge_mlp and lane_layer run in
float32 as well as bfloat16 (`DTYPES`). Each call shape
(A2M, M2A, A2A) of the forward and of the backward runs once per build (the
largest difference between the two builds' outputs is printed, and
whether they are bitwise equal;
`chip_smoke.py` holds each kernel to its plain version) and is then timed
in ROUNDS rounds, the order of old and new alternating from round to round:
each round the wrapper and, beside it, its bare C entries (`bare_ms`), each
a median of 25 runs (CUDA events).
Then each build's device time per call of every CUDA kernel it launches
(a backward's passes and partial sums) is read from torch.profiler, and
the host time of one call (the wrapper and its launches) from the host
clock. A kernel
only this checkout has is timed alone in the same rounds, so its spread
shows the noise within the call.

Prints one JSON line per kernel call shape, then the count of call shapes
whose outputs were bitwise equal in both builds (`bitwise`), and, before
the last line, the card's name and power limit; the last line is {"ok":
true}. Needs CUDA.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import chip_smoke as cs

ROUNDS = 8
# kernel library: ((geometry whose forward and train step run it, the
# forward op's capture name there), ...)
TARGETS = {"win_edge": (("windowed", "win_edge"),),
           "edge_mlp": (("contiguous", "edge_mlp"), ("lanercnn", "edge_mlp_pool"),
                        ("widths", "edge_mlp"), ("half_lanercnn", "edge_mlp_pool")),
           "lane_layer": (("windowed", "lane_layer"), ("half", "lane_layer"),
                          ("contiguous", "lane_layer")),
           "lane_plan": (("merged", "lane_plan"),),
           "band_conv": (("unfused", "band_conv"),),
           "segment_sum": (("windowed", "segment_sum"), ("lanercnn", "segment_sum"),
                           ("flat", "segment_sum")),
           "scenario_agg": (("windowed", "scenario_agg"), ("lanercnn", "scenario_agg")),
           "pair_agg": (("bench", "pair_agg"),),
           "row_tail": (("windowed", "row_tail"), ("lanercnn", "row_tail2"),
                        ("widths", "row_tail"), ("half_lanercnn", "row_tail2"),
                        ("contiguous", "row_tail")),
           "window_scatter": (("lanercnn", "window_scatter"),)}
# Kernel libraries timed in float32 as well as bfloat16 (default: bf16 only).
DTYPES = {k: ("bfloat16", "float32")
          for k in ("window_scatter", "row_tail", "edge_mlp", "lane_layer")}
# Kernel libraries whose C interface changed: the other tree's calls go
# through its own wrapper module (ops/<name>.py under that tree, loaded
# beside this checkout's package, its `cuda.call`s landing on the other
# build), with the leading arguments it takes: {name: {kernel: (wrapper,
# arguments)}}.
OWN_WRAPPERS = {"scenario_agg": {"scenario_agg": ("scenario_aggregate", 8),
                                 "scenario_agg_bwd": ("scenario_agg_bwd_cuda", 8)},
                "lane_plan": {"lane_plan": ("fused_lane_layer_plan", 17),
                              "lane_plan_bwd": ("lane_plan_bwd_cuda", 18)},
                "win_edge": {"win_edge": ("win_edge_mlp", 14),
                             "win_edge_bwd": ("win_edge_bwd_cuda", 14)},
                "pair_agg": {"pair_agg": ("pair_aggregate", 4),
                             "pair_agg_bwd": ("pair_agg_bwd_cuda", 4)},
                "row_tail": {"row_tail": ("fused_row_tail", 7),
                             "row_tail_bwd": ("row_tail_bwd_cuda", 8),
                             "row_tail2": ("fused_row_tail2", 10),
                             "row_tail2_bwd": ("row_tail2_bwd_cuda", 11)},
                "edge_mlp": {"edge_mlp": ("fused_edge_mlp", 12),
                             "edge_mlp_bwd": ("edge_mlp_bwd_cuda", 14),
                             "edge_mlp_pool": ("fused_edge_mlp", 14),
                             "edge_mlp_pool_bwd": ("edge_mlp_pool_bwd_cuda", 10)},
                "window_scatter": {"window_scatter": ("window_scatter_add", 5),
                                   "window_scatter_bwd": ("window_scatter_bwd_cuda", 4)},
                "lane_layer": {"lane_layer": ("fused_lane_layer", 10),
                               "lane_layer_bwd": ("lane_layer_bwd_cuda", 12)},
                "band_conv": {"band_conv": ("band_conv", 4),
                              "band_conv_bwd": ("band_conv_bwd_cuda", 5)}}
# Wrapper modules named other than their kernel library (ops/<module>.py),
# and the other tree's modules that its wrapper module imports in place of
# this checkout's (names it takes from them are gone here).
WRAPPER_MODULES = {"lane_plan": "lane_layer"}
OLD_IMPORTS = {"lane_plan": ("scenario_agg", "row_tail"), "lane_layer": ("row_tail",)}


def build_old(old_root: Path, name: str):
    """Build the other tree's kernel library with this checkout's flags;
    None where that tree has no such kernel."""
    from lanegcn_tpu_torch.ops import cuda

    src = old_root / "lanegcn_tpu_torch" / "csrc" / f"{name}.cu"
    if not src.exists():
        return None
    out = cuda._BUILD / "ab_old" / f"lib{name}-old-{os.getpid()}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the other tree's {name}.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def old_wrappers(old_root: Path, name: str):
    """{kernel: function} calling the other tree's own wrappers of library
    `name` (OWN_WRAPPERS), or {} where it has none or the interface is
    shared."""
    import importlib.util

    ops = old_root / "lanegcn_tpu_torch" / "ops"
    src = ops / f"{WRAPPER_MODULES.get(name, name)}.py"
    if name not in OWN_WRAPPERS or not src.exists():
        return {}

    def load(path, as_name):
        spec = importlib.util.spec_from_file_location(as_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    # The other tree's wrappers import their width check's table from
    # ops/cuda.py by name: they get the other tree's (a tuple of widths
    # before each entry had its own), the rest of this checkout's module.
    from lanegcn_tpu_torch.ops import cuda

    widths = cuda.WIDTHS
    cuda.WIDTHS = getattr(load(ops / "cuda.py", "ab_old_cuda"), "WIDTHS", widths)
    try:
        deps = {f"lanegcn_tpu_torch.ops.{d}": load(ops / f"{d}.py", f"ab_old_{d}")
                for d in OLD_IMPORTS.get(name, ())}
        saved = {k: sys.modules.get(k) for k in deps}
        sys.modules.update(deps)
        try:
            mod = load(src, f"ab_old_{name}")
        finally:
            for k, m in saved.items():
                if m is None:
                    del sys.modules[k]
                else:
                    sys.modules[k] = m
    finally:
        cuda.WIDTHS = widths
    return {k: (lambda *a, _f=getattr(mod, attr), _n=n: _f(*a[:_n]))
            for k, (attr, n) in OWN_WRAPPERS[name].items()}


def bare_ms(fn, runs: int = 25) -> float:
    """CUDA-event time of the C entries that one call of the wrapper `fn`
    launches, without the wrapper: each entry is timed alone (median of
    `runs`, uncounted) inside that call, on the arguments and tensors the
    wrapper made for it, then launched as usual. The wrapper's time less
    this one is what its host path adds."""
    from lanegcn_tpu_torch.ops import cuda

    launch, times = cuda.call, []

    def timed(name, entry, *args):
        c_fn = getattr(cuda.lib(name), entry)
        if c_fn.argtypes is None:
            c_fn.argtypes = [type(x) for x in args]
            c_fn.restype = ctypes.c_int
        times.append(cs.time_ms(lambda: c_fn(*args), runs))
        return launch(name, entry, *args)

    cuda.call = timed
    try:
        fn()
    finally:
        cuda.call = launch
    return sum(times)


def device_ms_by_kernel(fn, calls: int = 5) -> dict:
    """Device time per call of each CUDA kernel that fn launches
    (torch.profiler over `calls` calls after one warm call), by kernel
    name (cut to 60 characters), largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name[:60]] = by.get(e.name[:60], 0.0) + (e.time_range.end - e.time_range.start)
    return {k: v / 1e3 / calls for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def host_ms(fn, runs: int = 25) -> float:
    """Median host time of one call of fn (the wrapper's Python and the
    launches, without waiting for the device), the device drained before
    each call."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def prep_ms(feat, w_rel, lu, lv, rel, num_win, groups) -> float:
    """CUDA-event time of this checkout's plan preparation (with the
    backward's source order) for a captured scenario_agg or lane_plan call,
    which a LaneConv stack makes once for its layers and their backwards."""
    from lanegcn_tpu_torch.ops import scenario_agg

    return cs.time_ms(lambda: scenario_agg.prepare_plan(
        lu, lv, rel, num_win, feat.shape[0] // num_win, groups, w_rel.shape[0]))


def pair_prep_ms(a) -> float:
    """CUDA-event time of this checkout's pair-plan preparation for
    win_edge's captured backward call `a`, which a fusion stage makes once
    for its Att layers (the timed wrapper call is handed it, as in the
    model)."""
    from lanegcn_tpu_torch.ops import win_edge

    pd, ps, plan = a[0], a[2], a[12]
    return cs.time_ms(lambda: win_edge.prepare_pair(plan, pd.shape[0], ps.shape[0]))


def spill_prep_ms(feat, w_rel, plan, backward: bool) -> float:
    """CUDA-event time of this checkout's spill-plan preparation (with the
    source order for the backward, forward-only for serving), which a
    LaneGCN forward makes once for both stacks (the timed wrapper call is
    handed it, as in the model)."""
    from lanegcn_tpu_torch.ops import pair_agg

    return cs.time_ms(lambda: pair_agg.prepare_spill(plan, feat.shape[0], w_rel.shape[0],
                                                     backward))


def capture(geom):
    """(forward calls, backward calls) of one eval forward and one train step
    at bf16, keyed by kernel then by input shapes."""
    import torch
    from lanegcn_tpu_torch.graph import PackedBatch, RoiPackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    spec = cs.GEOMETRIES[geom]
    cfg = cs.pack_config(geom, spec["s"])
    roi = spec["model"] == "lanercnn"
    packs, _, _, _ = cs.make_packs(cfg, 1, spec["s"], seed0=0, roi=roi,
                                   pack_kw=cs.pack_kwargs(geom))
    if roi:
        batch = RoiPackedBatch.from_numpy(packs[0]).to("cuda")
        bundle = get_model("lanercnn", cfg, dtype=torch.bfloat16, seed=0)
        fns = dict(loss_fn=bundle.loss_fn, metrics_fn=bundle.metrics_fn)
        net, tcfg = bundle.net, bundle.config
        net_t, state = init_state(tcfg, net=get_model("lanercnn", cfg, dtype=torch.bfloat16,
                                                      seed=0).net)
    else:
        batch = PackedBatch.from_numpy(packs[0]).to("cuda")
        fns, tcfg = {}, cfg
        net = LaneGCN(cfg.model, dtype=torch.bfloat16, device="cuda", seed=0)
        net_t, state = init_state(cfg, dtype=torch.bfloat16)
    with cs.forward_capture() as fwd:
        make_eval_step(cfg, net, **fns)(batch)
    with cs.backward_capture() as bwd:
        make_train_step(tcfg, net_t, state, **fns)(batch, 0.0)
    torch.cuda.synchronize()
    return fwd.calls, bwd.calls


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: CUDA is not available")
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    old_root = Path(sys.argv[1]).resolve()
    names = sys.argv[2:] or list(TARGETS)
    from lanegcn_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda.build_all()  # the model's other kernels run in the captures
    libs = {n: {"new": cuda.lib(n), "old": build_old(old_root, n)} for n in names}
    old_fns = {n: old_wrappers(old_root, n) for n in names}
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "old_present": {n: v["old"] is not None for n, v in libs.items()}})

    bitwise = {"equal": 0, "of": 0, "differ": []}
    for name, geom, fwd_name in [(n, g, f) for n in names for g, f in TARGETS[n]]:
        fwd_calls, bwd_calls = capture(geom)
        if name == "segment_sum":  # the train step's calls: scatters and gathers' backwards
            ops, calls = cs.forward_ops([name]), {name: bwd_calls[name]}
        else:
            ops = {**cs.forward_ops([fwd_name]), **cs.backward_ops([fwd_name])}
            calls = {fwd_name: fwd_calls[fwd_name],
                     f"{fwd_name}_bwd": bwd_calls[f"{fwd_name}_bwd"]}
        versions = [v for v in ("old", "new") if libs[name][v] is not None]
        for kname, (fn, _) in ops.items():
            for ci, (key, args), dt in [(ci, ka, dt) for ci, ka in enumerate(calls[kname].items())
                                        for dt in DTYPES.get(name, ("bfloat16",))]:
                a = cs.cast_args(args, getattr(torch, dt))
                res = {"phase": "ab", "kernel": kname, "geometry": geom, "call": ci,
                       "rows": key[0][0], "dtype": dt, "gpu": smi}
                if kname == "segment_sum":
                    res["rows"] = a[2]
                    res["edges_kept"] = int((a[1] < a[2]).sum())
                    res["edge_slots"] = a[0].shape[0]
                    res["with_out"] = len(a) > 3 and a[3] is not None
                fns = {v: old_fns[name].get(kname, fn) if v == "old" else fn for v in versions}
                if name == "scenario_agg" and kname == "scenario_agg":
                    res["new_prep_ms"] = prep_ms(a[0], a[2], *a[3:8])
                if kname == "lane_plan":  # the call is handed the model's preparation
                    res["new_prep_ms"] = prep_ms(a[0], a[9], *a[10:14], a[15])
                if kname == "win_edge_bwd":
                    res["new_prep_ms"] = pair_prep_ms(a)
                if kname == "pair_agg":
                    res["new_prep_ms"] = spill_prep_ms(a[0], a[2], a[3], False)
                if kname == "pair_agg_bwd":
                    res["new_prep_ms"] = spill_prep_ms(a[0], a[1], a[2], True)
                outs = {}
                for v in versions:
                    cuda._LIBS[name] = libs[name][v]
                    out = fns[v](*a)
                    outs[v] = out if isinstance(out, (tuple, list)) else (out,)
                if len(versions) == 2:
                    res["old_vs_new_max_abs"] = max(
                        float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
                        for x, y in zip(outs["old"], outs["new"]))
                    res["old_vs_new_bitwise"] = all(
                        torch.equal(x, y) for x, y in zip(outs["old"], outs["new"]))
                    bitwise["of"] += 1
                    bitwise["equal"] += res["old_vs_new_bitwise"]
                    if not res["old_vs_new_bitwise"]:
                        bitwise["differ"].append([kname, geom, ci, dt])
                del outs
                samples = {v: [] for v in versions}
                bare = {v: [] for v in versions}
                for r in range(ROUNDS):
                    for v in (versions if r % 2 == 0 else versions[::-1]):
                        cuda._LIBS[name] = libs[name][v]
                        samples[v].append(cs.time_ms(lambda: fns[v](*a)))
                        bare[v].append(bare_ms(lambda: fns[v](*a)))
                for v in versions:
                    res[f"{v}_bare_ms_median"] = statistics.median(bare[v])
                for v in versions:
                    res[f"{v}_ms_median"] = statistics.median(samples[v])
                    res[f"{v}_ms_min"] = min(samples[v])
                    res[f"{v}_ms_max"] = max(samples[v])
                    res[f"{v}_ms_rounds"] = samples[v]
                if len(versions) == 2:
                    res["new_over_old"] = res["new_ms_median"] / res["old_ms_median"]
                for v in versions:  # device time of each pass (CUDA kernel) per call
                    cuda._LIBS[name] = libs[name][v]
                    res[f"{v}_device_ms_by_kernel"] = device_ms_by_kernel(lambda: fns[v](*a))
                    res[f"{v}_host_ms"] = host_ms(lambda: fns[v](*a))
                cs.emit(res)
        cuda._LIBS[name] = libs[name]["new"]
        del fwd_calls, bwd_calls, calls
        torch.cuda.empty_cache()
    cs.emit({"phase": "bitwise", **bitwise})
    print(smi, flush=True)
    cs.emit({"ok": True})


if __name__ == "__main__":
    main()
