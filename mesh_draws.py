#!/usr/bin/env python3
"""Count what the mesh split's sub-packs need (lanegcn_tpu_torch/parallel/
windowed_parallel.py): for each draw of S urban scenarios, split G ways by
`balance_scenarios`, pack each part at the subdivided capacities and the
whole draw at the full ones, and report the drops.

    python3 mesh_draws.py

Draws: S = 256 scenarios from each seed in SEEDS (seed, seed + 1, ...),
LaneGCN's with 7 corridors and 16 actors, LaneRCNN's with 7 corridors, 12
actors and their LaneRoIs, made with their pack caches on PROCS processes.
Geometries: bench_pack_config(S) and windowed_pack_config(S) split by
subdivide_pack_config, lanercnn_pack_config(S) by subdivide_roi_pack_config,
each with headroom 0 (the JAX package's formula) and with the family's
SPLIT_HEADROOM (the port's mesh). Prints one JSON line per geometry,
G and headroom: the draws, the draws that dropped an edge or skipped a
scenario, the drops by counter, and for LaneRCNN the most RoIs and RoI
nodes a part held against the part's capacity. Numpy packers only: runs
on the CPU.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import time
from concurrent.futures import ProcessPoolExecutor

S, SEEDS, GS, PROCS = 256, (0, 5000, 9000), (1, 2, 4), 8
SCENS: dict = {}  # (family, seed) → the draw, inherited by the forked packing workers


def make(job):
    from lanegcn_tpu_torch.config import ModelConfig
    from lanegcn_tpu_torch.data.packing import precompute_pack_cache
    from lanegcn_tpu_torch.data.packing_roi import precompute_roi_cache
    from lanegcn_tpu_torch.data.synthetic import make_roi_scenario, make_urban_scenario

    family, _, seeds = job
    out = []
    for seed in seeds:
        if family == "lanercnn":
            scen = make_roi_scenario(seed=seed, num_corridors=7, num_actors=12, urban=True)
            precompute_roi_cache(scen, ModelConfig())
        else:
            scen = make_urban_scenario(seed=seed, num_corridors=7, num_actors=16)
        precompute_pack_cache(scen, ModelConfig())
        out.append(scen)
    return out


def pack_parts(job):
    """(geometry, G, headroom, draw) → (drops, [(RoIs, RoI nodes) a part])."""
    from lanegcn_tpu_torch import config
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
    from lanegcn_tpu_torch.parallel import windowed_parallel as wp

    name, g, headroom, key = job
    scens = SCENS[key]
    whole = getattr(config, name)(S)
    if name == "lanercnn_pack_config":
        sub = wp.subdivide_roi_pack_config(whole, g, headroom)
    else:
        sub = wp.subdivide_pack_config(whole, g, headroom)
    drops, held = {}, []
    for grp in wp.balance_scenarios(scens, g, max_per_group=S // g):
        part = [scens[i] for i in grp]
        if name == "lanercnn_pack_config":
            _, st = pack_roi_batch(part, sub, config.ModelConfig())
            held.append((st["num_rois"], st["num_roi_nodes"]))
        else:
            _, st = pack_batch(part, sub, config.ModelConfig())
        for k, v in st.items():
            if k.startswith(("dropped", "graph_dropped", "skipped")) and v:
                drops[k] = drops.get(k, 0) + int(v)
    return drops, held


def main():
    t0 = time.perf_counter()
    jobs = [(fam, seed, range(seed + i, seed + S, PROCS))
            for fam in ("lanegcn", "lanercnn") for seed in SEEDS for i in range(PROCS)]
    with ProcessPoolExecutor(PROCS, mp_context=mp.get_context("spawn")) as pool:
        parts = list(pool.map(make, jobs))
    for (fam, seed, _), part in zip(jobs, parts):
        SCENS.setdefault((fam, seed), []).extend(part)
    gen_s = time.perf_counter() - t0
    from lanegcn_tpu_torch.parallel.windowed_parallel import SPLIT_HEADROOM

    runs = [(name, g, h) for name, fam in (("bench_pack_config", "lanegcn"),
                                           ("windowed_pack_config", "lanegcn"),
                                           ("lanercnn_pack_config", "lanercnn"))
            for g in GS for h in ((0.0,) if g == 1 else (0.0, SPLIT_HEADROOM[fam]))]
    for name, g, headroom in runs:
        t0 = time.perf_counter()
        fam = "lanercnn" if name == "lanercnn_pack_config" else "lanegcn"
        keys = [(fam, seed) for seed in SEEDS]
        with ProcessPoolExecutor(PROCS, mp_context=mp.get_context("fork")) as pool:
            res = list(pool.map(pack_parts, [(name, g, headroom, k) for k in keys]))
        drops = {}
        for d, _ in res:
            for k, v in d.items():
                drops[k] = drops.get(k, 0) + v
        line = {"geometry": f"{name}({S})", "G": g, "headroom": headroom,
                "seeds": list(SEEDS), "draws": len(res),
                "draws_with_drops": sum(1 for d, _ in res if d), "drops": drops,
                "gen_s": gen_s, "pack_s": time.perf_counter() - t0}
        if fam == "lanercnn":
            from lanegcn_tpu_torch import config
            from lanegcn_tpu_torch.parallel import windowed_parallel as wp

            sub = wp.subdivide_roi_pack_config(config.lanercnn_pack_config(S), g, headroom)
            line["most_rois"] = max(r for _, held in res for r, _ in held)
            line["most_roi_nodes"] = max(n for _, held in res for _, n in held)
            line["capacity"] = {"rois": sub.max_rois, "roi_nodes": sub.max_roi_nodes}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
