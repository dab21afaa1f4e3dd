#!/usr/bin/env python3
"""Profile the port's serve and train steps on one GPU for the
`lanegcn_tpu_torch` package found under a given directory, geometry by
geometry, so that two versions of the package (say, a commit and its
parent unpacked under build/) can be compared on one card in one call.

    python3 tree_profile.py DIR [GEOMETRY ...]
    # e.g. for d in build/parent . . build/parent; do python3 tree_profile.py $d; done

Geometries: windowed (windowed_pack_config(256)), bench
(bench_pack_config(256)), contiguous (contiguous_pack_config(32)),
lanercnn (lanercnn_pack_config(256), get_model("lanercnn")),
lanercnn_remat (lanercnn's packs, the train step's net built with
LaneRCNN(remat=True): its three LanePoolings' forwards run again in the
backward; the serve step is lanercnn's), unfused
(windowed's packs with ModelConfig(pallas_bands="off")), merged (bench's
packs with merge_plan_agg="auto") and flat (flat_pack_config(32) packed
without bands, tables or plan), the packs
made from the same seeds for every tree. For each: 2 packs, bf16 weights
from seed 0; the eval step and the train step warmed up, then
torch.profiler over one forward per pack and over one train step: the
device's busy time (the union of its kernels' intervals) per step, the
idle share of the host's wall time and the host syncs (`nonzero`,
`.item()`) per step; then the host clock over 10 un-profiled serve
forwards and 10 un-profiled train steps.
Peak device memory (`max_memory_allocated`, the packs, both models and the
optimizer state included) over the profiled forwards and over the 10
train steps.
One JSON line per geometry and step kind; the last line names the card.
Needs CUDA; uses only the package under DIR (and numpy).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

GEOMETRIES = {"windowed": ("windowed_pack_config", 256), "bench": ("bench_pack_config", 256),
              "contiguous": ("contiguous_pack_config", 32),
              "lanercnn": ("lanercnn_pack_config", 256),
              "lanercnn_remat": ("lanercnn_pack_config", 256),
              "unfused": ("windowed_pack_config", 256),
              "merged": ("bench_pack_config", 256), "flat": ("flat_pack_config", 32)}
# ModelConfig fields and pack_batch keyword arguments a geometry sets
MODEL_FIELDS = {"unfused": {"pallas_bands": "off"}, "merged": {"merge_plan_agg": "auto"}}
PACK_KWARGS = {"flat": {"split_bands": False, "split_tables": False, "scenario_plan": False}}
SYNCS = ("aten::nonzero", "aten::_local_scalar_dense")


def profile(step, items):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in items:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, syncs = [], dict.fromkeys(SYNCS, 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in syncs:
            syncs[e.name] += 1
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    n = len(items)
    return {"busy_ms_per_step": busy / 1e3 / n, "wall_ms_per_step": wall_us / 1e3 / n,
            "idle_share": 1.0 - busy / wall_us,
            "syncs_per_step": {k: v / n for k, v in syncs.items()}}


def run(tree, geom):
    import torch
    from lanegcn_tpu_torch import config
    from lanegcn_tpu_torch.data.synthetic import make_roi_scenario, make_urban_scenario
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    name, s = GEOMETRIES[geom]
    roi = geom.startswith("lanercnn")
    field = "roi_pack" if roi else "pack"
    cfg = config.Config(**{field: getattr(config, name)(s)})
    if geom in MODEL_FIELDS:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **MODEL_FIELDS[geom]))
    if roi:
        from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch as pack
        from lanegcn_tpu_torch.graph import RoiPackedBatch as Batch
        scens = [make_roi_scenario(seed=i, num_corridors=7, num_actors=12, urban=True)
                 for i in range(2 * s)]
    else:
        from lanegcn_tpu_torch.data.packing import pack_batch as pack
        from lanegcn_tpu_torch.graph import PackedBatch as Batch
        scens = [make_urban_scenario(seed=i, num_corridors=7, num_actors=16)
                 for i in range(2 * s)]
    batches = [Batch.from_numpy(pack(scens[p * s:(p + 1) * s], getattr(cfg, field), cfg.model,
                                     **PACK_KWARGS.get(geom, {}))[0]).to("cuda")
               for p in range(2)]
    bundle = get_model("lanercnn" if roi else "lanegcn", cfg, dtype=torch.bfloat16, seed=0)
    fns = dict(loss_fn=bundle.loss_fn, metrics_fn=bundle.metrics_fn)
    serve = make_eval_step(bundle.config, bundle.net, **fns)
    train_bundle = get_model("lanercnn" if roi else "lanegcn", cfg, dtype=torch.bfloat16, seed=0)
    if geom == "lanercnn_remat":
        from lanegcn_tpu_torch.models.lanercnn import LaneRCNN

        train_bundle = dataclasses.replace(train_bundle, net=LaneRCNN(
            train_bundle.config.model, dtype=torch.bfloat16, seed=0, remat=True))
    net, state = init_state(train_bundle.config, net=train_bundle.net)
    train = make_train_step(train_bundle.config, net, state, **fns)
    for b in batches:
        serve(b)
        train(b, 0.0)
    gib = lambda: torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    out = [("serve", profile(serve, batches))]
    out[0][1]["peak_mem_gib"] = gib()
    steps = 10
    t0 = time.perf_counter()
    for i in range(steps):
        serve(batches[i % 2])
    torch.cuda.synchronize()
    out[0][1]["host_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
    out.append(("train", profile(lambda b: train(b, 0.5), batches[:1])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(steps):
        train(batches[i % 2], 0.5)
    torch.cuda.synchronize()
    out[1][1]["host_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
    out[1][1]["peak_mem_gib"] = gib()
    for kind, res in out:
        print(json.dumps({"tree": tree, "geometry": geom, "step": kind, **res}), flush=True)


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    geoms = sys.argv[2:] or list(GEOMETRIES)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tree_profile: CUDA is not available")
    from lanegcn_tpu_torch.ops import cuda

    cuda.build_all()
    for geom in geoms:
        run(sys.argv[1], geom)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"tree": sys.argv[1], "card": smi[0] if smi else None,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
