"""The port's windowed split (lanegcn_tpu_torch/parallel/windowed_parallel.py)
against the JAX package's (lanegcn_tpu/parallel/windowed_parallel.py): the
scenario weight, the balanced split and the sub-pack capacities equal the
JAX functions', on seeded urban scenarios, LaneRCNN's RoI scenarios and the
skewed draw of tests/test_windowed_parallel.py, at G = 2 and 4; the port's
packer packs the balanced split of that draw clean at 1/G capacities where
a positional split drops; and the mesh loader gives every rank of a D×G
mesh the same number of steps, its graph row's groups split without
overlap."""

import dataclasses

import numpy as np
import pytest

from lanegcn_tpu.config import PackConfig as JPackConfig, RoiPackConfig as JRoiPackConfig
from lanegcn_tpu.data.lane_roi import generate_lane_rois as jax_generate_lane_rois
from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_synthetic
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.parallel import windowed_parallel as jwp

from lanegcn_tpu_torch.config import (
    Config,
    PackConfig,
    RoiPackConfig,
    bench_pack_config,
    contiguous_pack_config,
    lanercnn_pack_config,
    windowed_pack_config,
)
from lanegcn_tpu_torch.data.dataset import PackedLoader
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.parallel import windowed_parallel as wp


def _skew_scens():
    """3 dense urban scenarios side by side, then 13 sparse corridors (the
    draw of tests/test_windowed_parallel.py:293-350)."""
    dense = [jax_make_urban(seed=40 + i, num_corridors=6, num_actors=10) for i in range(3)]
    sparse = [jax_make_synthetic(seed=60 + i, num_corridors=1, num_actors=4) for i in range(13)]
    return dense + sparse


def _skew_cfg():
    return PackConfig(
        max_scenarios=16, max_actors=16 * 16, max_nodes=24 * 384, node_stride=384,
        max_plan_edges=1024, table_relations=(), max_edges_scale0=1024,
        max_edges_dilated=2048, max_edges_lr=512, max_a2m_edges=4096, max_m2a_edges=4096,
        max_a2a_edges=2048)


@pytest.fixture(scope="module")
def scens():
    urban = [jax_make_urban(seed=500 + i, num_corridors=3, num_actors=8) for i in range(8)]
    rois = [jax_generate_lane_rois(jax_make_synthetic(seed=700 + i, num_corridors=1,
                                                      num_actors=4)) for i in range(4)]
    return dict(urban=urban, rois=rois, skew=_skew_scens())


@pytest.mark.parametrize("kind", ["urban", "rois", "skew"])
@pytest.mark.parametrize("g", [2, 4])
def test_weight_and_balance_match_jax(scens, kind, g):
    group = scens[kind]
    assert [wp.scenario_weight(s) for s in group] == [jwp.scenario_weight(s) for s in group]
    for cap in (None, len(group) // g):
        got = wp.balance_scenarios(group, g, max_per_group=cap)
        assert got == jwp.balance_scenarios(group, g, max_per_group=cap)
        assert sorted(i for grp in got for i in grp) == list(range(len(group)))
    if kind == "skew":
        # The three dense scenarios spread over the groups (one a group at
        # G = 4).
        assert max(sum(1 for i in grp if i < 3) for grp in got) == -(-3 // g)


def _pack_configs():
    full = dict(max_scenarios=4, max_actors=64, actor_stride=16, max_nodes=2048,
                node_stride=256, max_plan_edges=512, max_edges_scale0=512,
                max_edges_dilated=768, max_edges_lr=256, max_a2m_edges=2048,
                max_m2a_edges=2048, max_a2a_edges=1024, fusion_pairs=True, table_relations=())
    return {"jax_test": PackConfig(**full), "bench": bench_pack_config(256),
            "windowed": windowed_pack_config(64), "contiguous": contiguous_pack_config(8)}


@pytest.mark.parametrize("name", ["jax_test", "bench", "windowed", "contiguous"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_subdivide_pack_config_matches_jax(name, g):
    cfg = _pack_configs()[name]
    got = dataclasses.asdict(wp.subdivide_pack_config(cfg, g))
    want = dataclasses.asdict(jwp.subdivide_pack_config(JPackConfig(**dataclasses.asdict(cfg)), g))
    assert got == want
    assert got["max_scenarios"] * g == cfg.max_scenarios


@pytest.mark.parametrize("name", ["jax_test", "lanercnn"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_subdivide_roi_pack_config_matches_jax(name, g):
    cfg = lanercnn_pack_config(256) if name == "lanercnn" else RoiPackConfig(
        max_scenarios=4, max_rois=32, max_roi_nodes=4096, max_interest_nodes=512,
        max_edges_scale0=3072, max_edges_dilated=4096, max_edges_lr=3072,
        max_a2m_edges=1024, max_pool_edges=12288, max_a2r_edges=2048)
    got = dataclasses.asdict(wp.subdivide_roi_pack_config(cfg, g))
    want = dataclasses.asdict(
        jwp.subdivide_roi_pack_config(JRoiPackConfig(**dataclasses.asdict(cfg)), g))
    assert got == want
    if g > 1:  # 1/G of the pool edges plus the chunks of alignment slack
        assert got["max_pool_edges"] % wp.WCHUNK == 0
        assert got["max_pool_edges"] >= cfg.max_pool_edges // g + wp.POOL_SLACK_CHUNKS * wp.WCHUNK


@pytest.mark.parametrize("g", [2, 4])
def test_headroom_widens_every_capacity_but_the_scenarios(g):
    """The mesh's sub-packs: each capacity at least the JAX formula's and
    about (1 + headroom) times it, aligned as the JAX formula aligns it;
    max_scenarios is still S/G."""
    for cfg, sub_fn, h in ((bench_pack_config(256), wp.subdivide_pack_config,
                            wp.SPLIT_HEADROOM["lanegcn"]),
                           (lanercnn_pack_config(256), wp.subdivide_roi_pack_config,
                            wp.SPLIT_HEADROOM["lanercnn"])):
        whole = dataclasses.asdict(cfg)
        base = dataclasses.asdict(sub_fn(cfg, g))
        wide = dataclasses.asdict(sub_fn(cfg, g, h))
        assert wide["max_scenarios"] == base["max_scenarios"] == cfg.max_scenarios // g
        for k, v in base.items():
            if k == "max_scenarios" or v == whole[k] or not v:  # not subdivided
                assert wide[k] == v, k
                continue
            for w, b in zip(np.atleast_1d(wide[k]), np.atleast_1d(v)):
                assert b < w <= (1 + h) * b + 768 + 4 * wp.WCHUNK, (k, b, w)
        if sub_fn is wp.subdivide_pack_config:
            assert wide["max_nodes"] % cfg.node_stride == 0
            assert wide["max_actors"] % cfg.actor_stride == 0


def test_subdivide_rejects_capacities_that_do_not_divide():
    with pytest.raises(ValueError, match="max_nodes"):
        wp.subdivide_pack_config(windowed_pack_config(8), 4)  # 9 node windows
    with pytest.raises(ValueError, match="max_scenarios"):
        wp.subdivide_roi_pack_config(lanercnn_pack_config(6), 4)


def test_balanced_split_packs_clean_where_positional_drops(scens):
    """At 1/4 capacities the positional split's dense shard drops or skips,
    the balanced split packs every scenario clean (the port's packer)."""
    group, g, cfg = scens["skew"], 4, _skew_cfg()
    sub = wp.subdivide_pack_config(cfg, g)
    mc = Config().model

    def pack_groups(groups):
        drops = packed = 0
        for grp in groups:
            _, st = pack_batch([group[i] for i in grp], sub, mc)
            packed += st["packed_scenarios"]
            drops += sum(int(np.sum(v)) for k, v in st.items()
                         if k.startswith(("dropped", "skipped")))
        return packed, drops

    bounds = np.linspace(0, len(group), g + 1).astype(int)
    pos_packed, pos_drops = pack_groups([list(range(bounds[k], bounds[k + 1]))
                                         for k in range(g)])
    bal = wp.balance_scenarios(group, g, max_per_group=sub.max_scenarios)
    assert pack_groups(bal) == (len(group), 0)
    assert pos_drops > 0 or pos_packed < len(group), (pos_packed, pos_drops)


def test_mesh_loader_gives_every_rank_the_same_steps(scens):
    """A 2x2 mesh over 19 scenarios in groups of 4: the shared order is cut
    to 16 (2 whole groups a data row), every rank takes 2 steps, and each
    step's two graph columns split their row's group without overlap, each
    part packed at the subdivided capacities."""
    data = scens["urban"] + scens["skew"][:11]  # 19 scenarios
    cfg = Config(pack=contiguous_pack_config(4))
    split_cfg = dataclasses.replace(cfg, pack=wp.subdivide_pack_config(cfg.pack, 2))
    seen = {}
    for d in range(2):
        full = PackedLoader(data, cfg, seed=3, process_index=d, process_count=2,
                            drop_last=True, packer=lambda s, c: (s, {}))
        groups = [[id(s) for s in grp] for grp in full.epoch(1)]
        assert full.steps_per_epoch() == len(groups) == 2
        for g in range(2):
            packed = []
            loader = PackedLoader(
                data, cfg, seed=3, process_index=d, process_count=2, drop_last=True,
                graph_split=wp.GraphSplit(g, 2, split_cfg),
                packer=lambda s, c: (([id(x) for x in s], c.pack.max_nodes), {}))
            assert loader.steps_per_epoch() == 2
            for step, (ids, nodes) in enumerate(loader.epoch(1)):
                assert nodes == split_cfg.pack.max_nodes and len(ids) == 2
                packed.append(ids)
                seen.setdefault((d, step), []).extend(ids)
        for step, grp in enumerate(groups):
            assert sorted(seen[(d, step)]) == sorted(grp)
    every = [i for ids in seen.values() for i in ids]
    assert len(every) == len(set(every)) == 16
    with pytest.raises(ValueError, match="whole group"):
        PackedLoader(data[:7], cfg, process_count=2, drop_last=True).steps_per_epoch()
