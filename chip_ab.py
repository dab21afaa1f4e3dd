#!/usr/bin/env python3
"""Time two builds of the port's CUDA kernels against each other on one GPU.

    git archive <commit> | tar -x -C build/ab_old     # the other tree
    python3 chip_ab.py build/ab_old [kernel ...]       # default: win_edge edge_mlp

For each named kernel library, the sources of this checkout ("new") and of
the other tree ("old", where it has that kernel) are built side by side
with the same nvcc flags. Both run through this checkout's wrappers (the
C interfaces must match) on the same inputs, captured from one bf16 eval
forward and one bf16 train step of the geometry that runs the kernel:
win_edge and lane_layer on windowed_pack_config(256), edge_mlp on
contiguous_pack_config(32), lane_plan on the merged geometry and band_conv
on the unfused one (chip_smoke.py GEOMETRIES). Each call shape (A2M, M2A, A2A) of the forward
and of the backward runs once per build (the largest difference between
the two builds' outputs is printed; `chip_smoke.py` holds each kernel to
its plain version) and is then timed in ROUNDS rounds, the order of old
and new alternating from round to round; each round's time is a median of 25 runs (CUDA events). A kernel
only this checkout has is timed alone in the same rounds, so its spread
shows the noise within the call.

Prints one JSON line per kernel call shape and, before the last line, the
card's name and power limit; the last line is {"ok": true}. Needs CUDA.
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
# kernel library: (geometry whose forward and train step run it, the
# forward op's capture name)
TARGETS = {"win_edge": ("windowed", "win_edge"), "edge_mlp": ("contiguous", "edge_mlp"),
           "lane_layer": ("windowed", "lane_layer"), "lane_plan": ("merged", "lane_plan"),
           "band_conv": ("unfused", "band_conv")}


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


def capture(geom):
    """(forward calls, backward calls) of one eval forward and one train step
    at bf16, keyed by kernel then by input shapes."""
    import torch
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    cfg = cs.pack_config(geom, cs.GEOMETRIES[geom]["s"])
    packs, _, _, _ = cs.make_packs(cfg, 1, cs.GEOMETRIES[geom]["s"], seed0=0,
                                   pack_kw=cs.pack_kwargs(geom))
    batch = PackedBatch.from_numpy(packs[0]).to("cuda")
    net = LaneGCN(cfg.model, dtype=torch.bfloat16, device="cuda", seed=0)
    with cs.forward_capture() as fwd:
        make_eval_step(cfg, net)(batch)
    net_t, state = init_state(cfg, dtype=torch.bfloat16)
    with cs.backward_capture() as bwd:
        make_train_step(cfg, net_t, state)(batch, 0.0)
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
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "old_present": {n: v["old"] is not None for n, v in libs.items()}})

    for name in names:
        geom, fwd_name = TARGETS[name]
        fwd_calls, bwd_calls = capture(geom)
        ops = {**cs.forward_ops([fwd_name]), **cs.backward_ops([fwd_name])}
        calls = {fwd_name: fwd_calls[fwd_name], f"{fwd_name}_bwd": bwd_calls[f"{fwd_name}_bwd"]}
        versions = [v for v in ("old", "new") if libs[name][v] is not None]
        for kname, (fn, _) in ops.items():
            for ci, (key, args) in enumerate(calls[kname].items()):
                a = cs.cast_args(args, torch.bfloat16)
                res = {"phase": "ab", "kernel": kname, "geometry": geom, "call": ci,
                       "rows": key[0][0], "gpu": smi}
                outs = {}
                for v in versions:
                    cuda._LIBS[name] = libs[name][v]
                    out = fn(*a)
                    outs[v] = out if isinstance(out, (tuple, list)) else (out,)
                if len(versions) == 2:
                    res["old_vs_new_max_abs"] = max(
                        float((x.float() - y.float()).abs().max()) if x.numel() else 0.0
                        for x, y in zip(outs["old"], outs["new"]))
                del outs
                samples = {v: [] for v in versions}
                for r in range(ROUNDS):
                    for v in (versions if r % 2 == 0 else versions[::-1]):
                        cuda._LIBS[name] = libs[name][v]
                        samples[v].append(cs.time_ms(lambda: fn(*a)))
                for v in versions:
                    res[f"{v}_ms_median"] = statistics.median(samples[v])
                    res[f"{v}_ms_min"] = min(samples[v])
                    res[f"{v}_ms_max"] = max(samples[v])
                    res[f"{v}_ms_rounds"] = samples[v]
                if len(versions) == 2:
                    res["new_over_old"] = res["new_ms_median"] / res["old_ms_median"]
                cs.emit(res)
        cuda._LIBS[name] = libs[name]["new"]
        del fwd_calls, bwd_calls, calls
        torch.cuda.empty_cache()
    print(smi, flush=True)
    cs.emit({"ok": True})


if __name__ == "__main__":
    main()
