"""The port's loader (lanegcn_tpu_torch/data/dataset.py), rotation augment
and preemption guard: the epoch order against the JAX package's
PackedLoader (in memory, and over a ShardDataset of 5 shards split across
2 processes), packs independent of the worker count, the skip of a resumed
epoch, one unpickle per shard in a shuffled epoch, RotationAugment against
the JAX one, and the guard's latch, second signal and restore."""

import os
import pickle
import signal

import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, PackConfig as JPackConfig
from lanegcn_tpu.data.augment import RotationAugment as JRotationAugment
from lanegcn_tpu.data.dataset import PackedLoader as JPackedLoader
from lanegcn_tpu.data.dataset import ShardDataset as JShardDataset

from lanegcn_tpu_torch.config import Config, PackConfig, contiguous_pack_config
from lanegcn_tpu_torch.data.augment import RotationAugment
from lanegcn_tpu_torch.data.dataset import PackedLoader, ShardDataset
from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.train.preempt import PreemptionGuard

SHARD_SIZES = (4, 3, 5, 4, 2)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """5 pickle shards of tiny records, 18 in all."""
    root = tmp_path_factory.mktemp("shards")
    n = 0
    for s, size in enumerate(SHARD_SIZES):
        with open(root / f"shard_{s:05d}.pkl", "wb") as f:
            pickle.dump([{"i": n + j} for j in range(size)], f)
        n += size
    return str(root)


@pytest.fixture(scope="module")
def scenarios():
    return [make_synthetic_scenario(seed=i, num_corridors=1, num_actors=4) for i in range(7)]


def _orders(loader, epochs=3):
    return [loader._epoch_order(e) for e in range(epochs)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_order_in_memory_matches_jax(shuffle):
    data = list(range(23))
    port = PackedLoader(data, Config(pack=PackConfig(max_scenarios=4)), shuffle=shuffle, seed=5)
    jax = JPackedLoader(data, JConfig(pack=JPackConfig(max_scenarios=4)), shuffle=shuffle, seed=5)
    for a, b in zip(_orders(port), _orders(jax)):
        np.testing.assert_array_equal(a, b)
    assert port.steps_per_epoch() == jax.steps_per_epoch() == 6


def test_epoch_order_over_shards_matches_jax_and_splits_processes(shard_dir):
    port_ds, jax_ds = ShardDataset(shard_dir), JShardDataset(shard_dir)
    assert port_ds.shard_spans == jax_ds.shard_spans and len(port_ds) == 18
    parts = []
    for pi in range(2):
        port = PackedLoader(port_ds, Config(pack=PackConfig(max_scenarios=3)), seed=1,
                            process_index=pi, process_count=2)
        jax = JPackedLoader(jax_ds, JConfig(pack=JPackConfig(max_scenarios=3)), seed=1,
                            process_index=pi, process_count=2)
        for a, b in zip(_orders(port), _orders(jax)):
            np.testing.assert_array_equal(a, b)
        parts.append(port._epoch_order(0))
    # The two processes' shares are disjoint and cover the epoch.
    assert not set(parts[0]) & set(parts[1])
    assert sorted(np.concatenate(parts).tolist()) == list(range(18))


def test_shuffled_epoch_loads_each_shard_once(shard_dir):
    ds = ShardDataset(shard_dir)
    seen = []
    loader = PackedLoader(ds, Config(pack=PackConfig(max_scenarios=4)), seed=2,
                          packer=lambda scens, cfg: ([s["i"] for s in scens], {}))
    ds._cache.clear()  # construction left the last shards cached
    before = ds.load_count
    for batch in loader.epoch(0):
        seen += batch
    assert ds.load_count - before == len(SHARD_SIZES)
    assert sorted(seen) == list(range(18))


def _packs(scenarios, workers, skip=0, fetched=None):
    class Counting(list):
        def __getitem__(self, i):
            if fetched is not None:
                fetched.append(i)
            return list.__getitem__(self, i)

    cfg = Config(pack=contiguous_pack_config(2))
    stats = []
    loader = PackedLoader(Counting(scenarios), cfg, seed=3, pack_workers=workers,
                          drop_stats=stats, to_device=True, device="cpu")
    packs = list(loader.epoch(1, skip=skip))
    return packs, stats, loader


def test_packs_do_not_depend_on_the_worker_count(scenarios):
    one, stats, loader = _packs(scenarios, 1)
    three, _, _ = _packs(scenarios, 3)
    assert len(one) == len(three) == loader.steps_per_epoch() == 4
    assert loader.transfer_s > 0.0 and loader.pack_s > 0.0
    for a, b in zip(one, three):
        assert isinstance(a, PackedBatch) and a.scen_mask.device.type == "cpu"
        la, lb = a.leaves(), b.leaves()
        assert len(la) == len(lb) > 50
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y)
    # The last pack holds the epoch's odd scenario, padded.
    assert sum(s["packed_scenarios"] for s in stats) == 7
    assert not any(v for s in stats for k, v in s.items() if k.startswith("dropped"))


def test_skip_fetches_nothing_it_skips(scenarios):
    full, _, loader = _packs(scenarios, 2)
    fetched = []
    tail, _, _ = _packs(scenarios, 2, skip=2, fetched=fetched)
    assert len(tail) == 2
    for a, b in zip(full[2:], tail):
        for x, y in zip(a.leaves(), b.leaves()):
            assert torch.equal(x, y)
    assert sorted(fetched) == sorted(loader._epoch_order(1)[4:].tolist())


def test_rotation_augment_matches_jax(scenarios):
    data = scenarios[:3]
    port, jax = RotationAugment(data, seed=7), JRotationAugment(data, seed=7)
    for i in range(3):
        a, b = port[i], jax[i]
        assert a.keys() == b.keys() and a["graph"].keys() == b["graph"].keys()
        for k in a:
            if k != "graph":
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for k in a["graph"]:
            np.testing.assert_array_equal(np.asarray(a["graph"][k]), np.asarray(b["graph"][k]))
        assert a["theta"] != data[i]["theta"]


def test_preemption_guard_latches_reraises_and_restores():
    hits = []

    def previous(*_):
        hits.append("previous")

    before = signal.signal(signal.SIGTERM, previous)
    try:
        with PreemptionGuard(signals=(signal.SIGTERM,)) as g:
            assert not g.triggered
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.triggered and g.signal_name == "SIGTERM" and hits == []
            # A second signal goes to the handler that was there before.
            os.kill(os.getpid(), signal.SIGTERM)
            assert hits == ["previous"]
        assert signal.getsignal(signal.SIGTERM) is previous
    finally:
        signal.signal(signal.SIGTERM, before)
