#!/usr/bin/env python3
"""Count what the port's windowed pack geometries need on shuffled packs,
for the `lanegcn_tpu_torch` package found under a given directory (say, a
commit and its parent unpacked under build/).

    python3 pack_draws.py DIR

Makes N urban scenarios (7 corridors, 16 actors, seeds 0..N-1) with their
pack caches on PROCS processes, draws them as an in-memory `PackedLoader`
does (epoch e's order is default_rng(e).permutation(N), cut into groups
of S), and packs every group of EPOCHS epochs with bench_pack_config(S) and
windowed_pack_config(S). Prints one JSON line per geometry: the draws, the
draws that dropped an edge or a scenario, the drops by counter, and the
most each capacity-bound list held against its capacity (live edges of
each classic list; chunk-aligned slots of the A2M, M2A and A2A pair plans
and of the spill plan). Numpy packers only: runs on the CPU.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

GEOMETRIES = ("bench_pack_config", "windowed_pack_config")
# The `loader` phase's scenarios and packs in chip_smoke.py, over 12 epochs.
N, S, EPOCHS, PROCS = 1024, 256, 12, 8
SCENS: list = []  # the scenarios, inherited by the forked packing workers


def make(seeds):
    from lanegcn_tpu_torch.config import ModelConfig
    from lanegcn_tpu_torch.data.packing import precompute_pack_cache
    from lanegcn_tpu_torch.data.synthetic import make_urban_scenario

    out = []
    for seed in seeds:
        scen = make_urban_scenario(seed=seed, num_corridors=7, num_actors=16)
        precompute_pack_cache(scen, ModelConfig())
        out.append(scen)
    return out


def _plan_slots(plan):
    """Chunk-aligned slots of a pair plan that hold at least one edge."""
    if plan is None:
        return 0
    live = (plan.idx[:, 0] >= 0).reshape(-1, plan.chunk).any(1)
    return int(live.sum()) * plan.chunk


def pack_one(job):
    """(geometry, s, group) → drops and what each list held."""
    from lanegcn_tpu_torch import config
    from lanegcn_tpu_torch.data.packing import pack_batch

    name, s, group = job
    cfg = config.Config(pack=getattr(config, name)(s))
    batch, stats = pack_batch([SCENS[i] for i in group], cfg.pack, cfg.model)
    held = {nm: int(e.mask.sum()) for nm, e in batch.graph.edges.items()}
    for nm in ("a2m", "m2a", "a2a"):
        held[f"pair_{nm}"] = _plan_slots(getattr(batch.fusion, f"pair_{nm}"))
    held["spill_pair"] = _plan_slots(batch.graph.spill_pair)
    drops = {k: int(v) for k, v in stats.items()
             if k.startswith(("dropped", "skipped")) and v}
    return drops, held


def capacities(pack_cfg, names):
    caps = {nm: pack_cfg.edge_capacity(nm) for nm in names
            if not nm.startswith(("pair_", "spill_"))}
    caps.update(pair_a2m=pack_cfg.max_a2m_edges, pair_m2a=pack_cfg.max_m2a_edges,
                pair_a2a=pack_cfg.max_a2a_edges,
                spill_pair=pack_cfg.max_spill_pair_edges if pack_cfg.spill_pairs else 0)
    return caps


def main():
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    from lanegcn_tpu_torch import config

    t0 = time.perf_counter()
    chunks = [list(range(i * N // PROCS, (i + 1) * N // PROCS)) for i in range(PROCS)]
    with ProcessPoolExecutor(PROCS, mp_context=mp.get_context("spawn")) as pool:
        SCENS.extend(sc for part in pool.map(make, chunks) for sc in part)
    gen_s = time.perf_counter() - t0
    groups = [order[i:i + S].tolist()
              for e in range(EPOCHS)
              for order in [np.random.default_rng(e).permutation(N)]
              for i in range(0, N, S)]
    for name in GEOMETRIES:
        t0 = time.perf_counter()
        with ProcessPoolExecutor(PROCS, mp_context=mp.get_context("fork")) as pool:
            res = list(pool.map(pack_one, [(name, S, g) for g in groups]))
        drops, most = {}, {}
        for d, held in res:
            for k, v in d.items():
                drops[k] = drops.get(k, 0) + v
            for k, v in held.items():
                most[k] = max(most.get(k, 0), v)
        caps = capacities(getattr(config, name)(S), list(most))
        print(json.dumps({
            "tree": sys.argv[1], "geometry": f"{name}({S})", "scenarios": N, "draws": len(res),
            "draws_with_drops": sum(1 for d, _ in res if d), "drops": drops,
            "most": most, "capacity": {k: caps[k] for k in most},
            "gen_s": gen_s, "pack_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
