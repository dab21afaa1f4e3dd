#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its LaneGCN eval path on one GPU.

    python3 chip_smoke.py            # one card, no arguments

Phases, one JSON line each; any failure raises and exits non-zero:
  env     torch / CUDA / Triton / nvcc versions, the card's name and power
          limit, and the kernels' build time (one nvcc per source, in
          parallel).
  pack    2 packs of synthetic urban scenarios in the production windowed
          geometry (node_stride 768, window plan 2048, actor_stride 128,
          fusion pair plans, spill_pairs off), zero drops asserted.
  kernel  each kernel against its plain PyTorch version on the inputs the
          eval path hands it (captured from one forward), in float32 (TF32
          off) and bfloat16: the error beside its tolerance and the output's
          scale, kernel and plain times (CUDA events, median of 25 runs),
          and the bound from the work these inputs need.
  parity  the full float32 forward + loss on the card (kernels) against the
          same on the CPU (plain versions), 8 scenarios, same weights.
  serve   make_eval_step in bfloat16 over the 2 packs, several rounds: ms per
          pack, scen/s, loss/ade/fde/mr, peak device memory, and the kernel
          launch counts of that run (per forward: lane_layer 8, scenario_agg
          8, win_edge 6, row_tail 6).
  profile device time by kernel name over one forward per pack (torch.profiler,
          after the counted serve run), and the device's idle share.
Then the `kernels` summary line, the nvidia-smi name/power-limit line, and
last the `ok` line with the device.

Weights are random (seeded); no dataset or checkpoint is needed.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): bf16 tensor-core rate and HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel-vs-plain tolerances, scaled by the plain output's RMS (its typical
# magnitude: the maximum of an accumulated sum can be many times larger).
# Each element: |kernel − plain| ≤ TOL · (rms + |plain|). Over the output:
# rms(kernel − plain) ≤ RMS_TOL · rms.
# float32: both sum 128-term products in fp32 in different orders, and the
# GroupNorms divide by row deviations; 1e-4 per element and 1e-5 in RMS
# leave ~100x room over the expected 1e-7..1e-6 reorder error.
# bfloat16: both round the same intermediates to bf16, but a reorder can
# flip one rounding (one bf16 ulp = 2^-8 relative), which then propagates
# through a GN and a product; 3e-2 is ~8 ulps per element. Flips are rare,
# so over the output the error stays near one final rounding (~2^-9 RMS):
# 1e-2 (~2.5 ulps RMS) holds it there, where a wrong bf16 load or store
# gives an RMS error of order 1.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
RMS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

KERNEL_META = {
    "lane_layer": ("lanegcn_tpu_torch/csrc/lane_layer.cu",
                   "lanegcn_tpu/ops/pallas_lane_layer.py:254"),
    "scenario_agg": ("lanegcn_tpu_torch/csrc/scenario_agg.cu",
                     "lanegcn_tpu/ops/pallas_scenario_agg.py:252"),
    "win_edge": ("lanegcn_tpu_torch/csrc/win_edge.cu",
                 "lanegcn_tpu/ops/pallas_win_edge.py:262"),
    "row_tail": ("lanegcn_tpu_torch/csrc/row_tail.cu",
                 "lanegcn_tpu/ops/pallas_row_tail.py:152"),
}
PER_FORWARD = {"lane_layer": 8, "scenario_agg": 8, "win_edge": 6, "row_tail": 6}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


def make_packs(cfg, num_packs: int, s: int, seed0: int):
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.synthetic import make_urban_scenario

    t0 = time.perf_counter()
    scens = [make_urban_scenario(seed=seed0 + i, num_corridors=7, num_actors=16)
             for i in range(num_packs * s)]
    gen_s = time.perf_counter() - t0
    packs, stats = [], []
    t0 = time.perf_counter()
    for p in range(num_packs):
        b, st = pack_batch(scens[p * s:(p + 1) * s], cfg.pack, cfg.model)
        packs.append(b)
        stats.append(st)
    pack_s = time.perf_counter() - t0
    for st in stats:
        bad = {k: v for k, v in st.items()
               if k.startswith(("dropped", "skipped")) and v}
        check(not bad, f"pack dropped edges or skipped scenarios: {bad}")
        check(st["packed_scenarios"] == s, f"packed {st['packed_scenarios']} of {s}")
    return packs, stats, gen_s, pack_s


def time_ms(fn, runs: int = 25, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cast_args(args, dtype):
    """bf16 tensors → dtype; everything else unchanged."""
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            a = a.to(dtype)
        out.append(a)
    return out


class Capture:
    """Records the first call's arguments of each kernel wrapper (per input
    shape) as the model modules see them, then calls through."""

    def __init__(self):
        from lanegcn_tpu_torch.models import fusion, map_net

        self.targets = [
            (map_net, "fused_lane_layer", "lane_layer"),
            (map_net, "scenario_aggregate", "scenario_agg"),
            (fusion, "win_edge_mlp", "win_edge"),
            (fusion, "fused_row_tail", "row_tail"),
        ]
        self.calls = {name: {} for _, _, name in self.targets}
        self.counts = {name: {} for _, _, name in self.targets}

    def __enter__(self):
        import torch

        self.saved = []
        for mod, attr, name in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def rec(*args, _fn=fn, _name=name):
                key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
                self.counts[_name][key] = self.counts[_name].get(key, 0) + 1
                if key not in self.calls[_name]:
                    self.calls[_name][key] = [
                        a.clone() if isinstance(a, torch.Tensor) else a for a in args
                    ]
                return _fn(*args)

            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def kernel_phase(calls, counts):
    """Kernel vs plain on the captured inputs; returns per-kernel results of
    the first (largest-row) call shape, with `ms_per_forward`: the kernel
    time of every call shape times its calls in the captured forward."""
    import torch
    from lanegcn_tpu_torch.ops import lane_layer, row_tail, scenario_agg, win_edge

    ops = {
        "lane_layer": (lane_layer.fused_lane_layer, lane_layer.lane_layer_plain),
        "scenario_agg": (scenario_agg.scenario_aggregate, scenario_agg.scenario_agg_plain),
        "win_edge": (win_edge.win_edge_mlp, win_edge.win_edge_plain),
        "row_tail": (row_tail.fused_row_tail, row_tail.row_tail_plain),
    }
    summary = {}
    for name, (fn, plain) in ops.items():
        check(bool(calls[name]), f"{name}: the eval path never called this kernel")
        per_forward = 0.0
        for ci, (key, args) in enumerate(calls[name].items()):
            res = {"phase": "kernel", "name": name, "call": ci,
                   "calls_per_forward": counts[name][key]}
            for dtype in (torch.float32, torch.bfloat16):
                a = cast_args(args, dtype)
                out_k = fn(*a)
                out_p = plain(*a)
                torch.cuda.synchronize()
                ref = out_p.float()
                diff = (out_k.float() - ref).abs()
                tag = str(dtype).split(".")[-1]
                rms = float(ref.square().mean().sqrt())
                check(rms > 0, f"{name} {tag}: the plain output is all zeros")
                # worst element's error as a share of its own tolerance
                worst = float((diff / (TOL[tag] * (rms + ref.abs()))).max())
                rel_rms = float(diff.square().mean().sqrt()) / rms
                res[tag] = {"max_abs_err": float(diff.max()), "rms": rms,
                            "max_abs": float(ref.abs().max()), "tol_abs": TOL[tag] * rms,
                            "tol_rel": TOL[tag], "err_over_tol": worst,
                            "rel_rms_err": rel_rms, "rel_rms_tol": RMS_TOL[tag],
                            "shape": list(out_k.shape)}
                check(bool(torch.isfinite(out_k).all()), f"{name} {tag}: non-finite output")
                check(worst <= 1.0, f"{name} {tag}: an element's error is {worst} x its "
                      f"tolerance {TOL[tag]} * (rms {rms} + |plain|)")
                check(rel_rms <= RMS_TOL[tag],
                      f"{name} {tag}: RMS error {rel_rms} of the output's RMS > {RMS_TOL[tag]}")
                if dtype == torch.bfloat16:
                    res["ms"] = time_ms(lambda: fn(*a))
                    res["plain_ms"] = time_ms(lambda: plain(*a))
                    res["work"] = work_of(name, a)
            emit(res)
            per_forward += res["ms"] * counts[name][key]
            if ci == 0:
                summary[name] = res
        summary[name]["ms_per_forward"] = per_forward
    return summary


def work_of(name, a):
    from lanegcn_tpu_torch.ops import lane_layer, row_tail, scenario_agg, win_edge

    if name == "lane_layer":
        w = lane_layer.work(a[0], a[2])
    elif name == "scenario_agg":
        w = scenario_agg.work(a[0], a[3], a[4], a[5], a[2], a[6], a[7])
    elif name == "win_edge":
        w = win_edge.work(a[0], a[2], a[13])
    else:
        w = row_tail.work(a[0].shape[0], a[0].element_size())
    t_bytes = w["bytes"] / PEAK_HBM_BYTES * 1e3
    t_ops = w["flops"] / PEAK_BF16_FLOPS * 1e3
    w["bound_ms"] = max(t_bytes, t_ops)
    w["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return w


def parity_phase():
    """Full float32 forward + loss: card (kernels) vs CPU (plain versions)."""
    import torch
    from lanegcn_tpu_torch.config import Config, windowed_pack_config
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.train.loop import make_eval_step

    s = 8
    cfg = Config(pack=windowed_pack_config(s))
    packs, _, _, _ = make_packs(cfg, 1, s, seed0=10_000)
    batch = PackedBatch.from_numpy(packs[0])
    net_gpu = LaneGCN(cfg.model, dtype=torch.float32, device="cuda", seed=1)
    net_cpu = LaneGCN(cfg.model, dtype=torch.float32, device="cpu", seed=1)
    net_cpu.load_state_dict({k: v.cpu() for k, v in net_gpu.state_dict().items()})
    out_g, m_g = make_eval_step(cfg, net_gpu)(batch)
    out_c, m_c = make_eval_step(cfg, net_cpu, device="cpu")(batch)
    err = {k: float((out_g[k].cpu() - out_c[k]).abs().max()) for k in ("cls", "reg")}
    scale = {k: max(1.0, float(out_c[k].abs().max())) for k in ("cls", "reg")}
    loss_g, loss_c = float(m_g["loss"]), float(m_c["loss"])
    err["loss"] = abs(loss_g - loss_c)
    scale["loss"] = max(1.0, abs(loss_c))
    # float32 on both sides; the card sums in other orders (kernels, cuBLAS,
    # cuDNN without TF32) through ~20 GroupNorm'd layers: 1e-3 relative.
    tol = {k: 1e-3 * scale[k] for k in err}
    emit({"phase": "parity", "scenarios": s, "max_abs_err": err, "tol": tol,
          "loss_gpu": loss_g, "loss_cpu": loss_c})
    for k in err:
        check(err[k] <= tol[k], f"parity {k}: {err[k]} > {tol[k]}")


def profile_phase(step, batches) -> None:
    """torch.profiler (CUPTI) over one forward per pack: device time by kernel
    name and the device's idle share of the host wall time (which includes
    the profiler's own overhead, so the share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (t1 - t0))
    check(bool(spans), "profile: no device activity was traced")
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):  # union of the device intervals
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    emit({"phase": "profile", "forwards": len(batches), "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us,
          "by_name": [[name[:90], n, us / 1e3] for name, (n, us) in top]})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    from lanegcn_tpu_torch.config import Config, windowed_pack_config
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.loop import MetricAccumulator, make_eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- env + build ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    build = cuda.build_all()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln][:6]
        for name, log in build["ptxas"].items()
    }
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "triton": triton_version, "nvcc": nvcc, "gpu": smi,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "build_s": build["seconds"], "ptxas": ptxas})

    # --- pack ---
    s = 256
    cfg = Config(pack=windowed_pack_config(s))
    packs, stats, gen_s, pack_s = make_packs(cfg, 2, s, seed0=0)
    t0 = time.perf_counter()
    batches = [PackedBatch.from_numpy(b).to("cuda") for b in packs]
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    st = stats[0]
    emit({"phase": "pack", "scenarios_per_pack": s, "packs": len(packs),
          "gen_s": gen_s, "pack_s": pack_s, "transfer_s": transfer_s,
          "nodes": st["num_nodes"], "node_cap": cfg.pack.max_nodes,
          "actors": st["num_actors"], "plan_edges": st["plan_edges"],
          "spilled_plan_edges": st["spilled_plan_edges"]})

    net = LaneGCN(cfg.model, dtype=torch.bfloat16, device="cuda", seed=0)
    step = make_eval_step(cfg, net)

    # --- kernels against their plain versions, on the eval path's inputs ---
    with Capture() as cap:
        step(batches[0])
    torch.cuda.synchronize()
    results = kernel_phase(cap.calls, cap.counts)
    del cap

    # --- card vs CPU, float32 ---
    parity_phase()

    # --- serve: the main path, counted ---
    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds = 5
    acc = MetricAccumulator()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(rounds * len(batches)):
        _, m = step(batches[i % len(batches)])
        acc.update(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = cuda.launch_counts()
    forwards = rounds * len(batches)
    summ = acc.summary()
    emit({"phase": "serve", "scenarios_per_pack": s, "forwards": forwards,
          "ms_per_pack": dt / forwards * 1e3, "scen_per_s": s * forwards / dt,
          "loss": summ["loss"], "ade": summ["ade"], "fde": summ["fde"], "mr": summ["mr"],
          "host_pack_s_per_pack": pack_s / len(packs),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "kernel_ms_per_forward": sum(r["ms_per_forward"] for r in results.values()),
          "launches": counts,
          "launches_per_forward": {k: v / forwards for k, v in counts.items()}})
    for k in ("loss", "ade", "fde", "mr"):
        check(math.isfinite(summ[k]), f"non-finite {k}: {summ[k]}")
    for name, per in PER_FORWARD.items():
        check(counts[name] == per * forwards,
              f"{name}: {counts[name]} launches in {forwards} forwards, expected {per} each")
    profile_phase(step, batches)

    kernels = []
    for name, res in results.items():
        source, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "launches_per_forward": counts[name] // forwards,
            "max_abs_err": res["bfloat16"]["max_abs_err"],
            "rms": res["bfloat16"]["rms"], "tol_abs": res["bfloat16"]["tol_abs"],
            "err_over_tol": res["bfloat16"]["err_over_tol"],
            "rel_rms_err": res["bfloat16"]["rel_rms_err"],
            "max_abs_err_fp32": res["float32"]["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "ms_per_forward": res["ms_per_forward"],
            "bound_ms": res["work"]["bound_ms"], "bound_by": res["work"]["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()  # any failure raises: traceback and a non-zero exit
