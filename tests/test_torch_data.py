"""The port's host data pipeline (its own copies of the synthetic generator,
lane-graph builder and packer) against the JAX package's, leaf by leaf with
exact equality.

The JAX package tries its optional native helpers first; the port always
runs the numpy/scipy versions. The tests switch the native helpers off on
the JAX side, so both run the same numpy paths.
"""

import dataclasses

import numpy as np
import pytest

import lanegcn_tpu.native as jax_native
from lanegcn_tpu.config import ModelConfig as JModelConfig, PackConfig as JPackConfig
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import (
    make_synthetic_scenario as jax_make_synthetic,
    make_urban_scenario as jax_make_urban,
)

from lanegcn_tpu_torch.config import ModelConfig, PackConfig
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario, make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch


@pytest.fixture(autouse=True)
def _numpy_paths(monkeypatch):
    for name in ("dilated_nbrs", "threshold_edges", "cross_edges"):
        monkeypatch.setattr(jax_native, name, lambda *a, **k: None)


def _assert_same(port, ref, path="root"):
    """Recursive exact comparison of the port's structure against the JAX one."""
    if port is None or ref is None:
        assert port is None and ref is None, path
    elif isinstance(port, dict):
        assert isinstance(ref, dict) and set(port) == set(ref), path
        for k in port:
            _assert_same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{path}[{i}]")
    elif dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _assert_same(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(port, np.ndarray) or isinstance(ref, np.ndarray):
        a, b = np.asarray(port), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert port == ref, (path, port, ref)


@pytest.mark.parametrize("urban", [True, False], ids=["urban", "corridors"])
def test_synthetic_scenarios_match(urban):
    for seed in (3, 11):
        if urban:
            port = make_urban_scenario(seed=seed, num_corridors=4, num_actors=8)
            ref = jax_make_urban(seed=seed, num_corridors=4, num_actors=8)
        else:
            port = make_synthetic_scenario(seed=seed, num_corridors=2, num_actors=6)
            ref = jax_make_synthetic(seed=seed, num_corridors=2, num_actors=6)
        _assert_same(port, ref)


GEOMETRIES = {
    # The slice's geometry: windowed nodes + grouped window plan, no tables,
    # window-pair fusion plans, residue in the edge lists.
    "windowed": dict(
        max_scenarios=3, max_actors=96, max_nodes=512 * 4, node_stride=512,
        max_plan_edges=1024, table_relations=(), actor_stride=32, fusion_pairs=True,
        pair_chunk=128, max_edges_scale0=512, max_edges_dilated=512, max_edges_lr=512,
        max_a2m_edges=6144, max_m2a_edges=6144, max_a2a_edges=1536),
    # Spill pair plan on (the next slice's layout).
    "windowed-spill": dict(
        max_scenarios=3, max_actors=96, max_nodes=512 * 4, node_stride=512,
        max_plan_edges=1024, table_relations=(), actor_stride=32, fusion_pairs=True,
        spill_pairs=True, max_spill_pair_edges=4096, max_edges_scale0=256,
        max_edges_dilated=256, max_edges_lr=256, max_a2m_edges=6144, max_m2a_edges=6144,
        max_a2a_edges=1536),
    # Contiguous layout with left/right neighbor tables and flat fusion lists.
    "contiguous": dict(
        max_scenarios=3, max_actors=64, max_nodes=2048, max_edges_scale0=1024,
        max_edges_dilated=1024, max_edges_lr=512, max_a2m_edges=4096,
        max_m2a_edges=4096, max_a2a_edges=512),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_pack_batch_matches(geometry):
    kw = GEOMETRIES[geometry]
    port_scens = [make_urban_scenario(seed=20 + i, num_corridors=3, num_actors=8)
                  for i in range(3)]
    ref_scens = [jax_make_urban(seed=20 + i, num_corridors=3, num_actors=8) for i in range(3)]
    port, port_stats = pack_batch(port_scens, PackConfig(**kw), ModelConfig())
    ref, ref_stats = jax_pack_batch(ref_scens, JPackConfig(**kw), JModelConfig())
    assert port_stats == ref_stats
    assert port_stats["packed_scenarios"] == 3
    _assert_same(port, ref)
    # The torch view keeps every value (int64 where torch indexes, int32 plans).
    tb = PackedBatch.from_numpy(port)
    np.testing.assert_array_equal(tb.graph.ctrs.numpy(), port.graph.ctrs)
    np.testing.assert_array_equal(tb.fusion.a2m.u.numpy(), port.fusion.a2m.u)
    if port.graph.plan_lu is not None:
        assert str(tb.graph.plan_lu.dtype) == "torch.int32"
        np.testing.assert_array_equal(tb.graph.plan_lu.numpy(), port.graph.plan_lu)
