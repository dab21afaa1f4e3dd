"""Datasets + the packed-batch loader with background host-side packing,
the port's counterpart of lanegcn_tpu/data/dataset.py.

Replaces the reference's DataLoader + giant-pickle flow (reference
data.py:16-105, preprocess_data.py:242-263) with:
- ShardDataset: per-scenario dicts from a directory of .pkl pickle shards
  (the preprocess CLI writes these), or SyntheticDataset /
  RoiSyntheticDataset, generated by index;
- PackedLoader: shuffles scenario order and packs fixed-capacity batches on
  background threads; with to_device it also turns each pack into a
  PackedBatch (RoiPackedBatch) and copies it to the card on a side stream,
  so the step waits on neither.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from lanegcn_tpu_torch.config import Config
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario
from lanegcn_tpu_torch.device import resolve_device
from lanegcn_tpu_torch.graph import tree_kind

# Unpickled shards a ShardDataset keeps (LRU); PackedLoader's shuffle mixes
# scenarios within windows of one shard fewer, so a shuffled epoch
# unpickles each shard once.
CACHE_SHARDS = 3

class SyntheticDataset:
    """Deterministic synthetic scenarios by index (tests, benches, demos).
    urban=True produces junction-rich (fork/merge/connector) graphs."""

    def __init__(
        self, size: int, num_corridors: int = 3, num_actors: int = 12,
        urban: bool = False,
    ):
        self.size = size
        self.num_corridors = num_corridors
        self.num_actors = num_actors
        self.urban = urban

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict:
        return make_synthetic_scenario(
            seed=idx, num_corridors=self.num_corridors,
            num_actors=self.num_actors, urban=self.urban,
        )


class RoiSyntheticDataset(SyntheticDataset):
    """Synthetic scenarios with per-agent LaneRoI subgraphs (LaneRCNN)."""

    def __getitem__(self, idx: int) -> Dict:
        from lanegcn_tpu_torch.data.lane_roi import generate_lane_rois

        return generate_lane_rois(super().__getitem__(idx))


class ShardDataset:
    """Preprocessed scenarios stored as pickle shards (dir of .pkl files,
    each a list of scenario dicts; the preprocess CLI writes these). Unpickle
    only shards this program wrote: unpickling runs code.

    Keeps at most CACHE_SHARDS unpickled shards in memory (LRU); random
    access outside the cached window costs one unpickle. PackedLoader's
    windowed shard-aware shuffle (see _epoch_order) keeps accesses inside
    the window, so a full-epoch shuffled pass with one pack worker unpickles
    each shard exactly once. The cache is locked: the loader's pack workers
    read it from several threads."""

    def __init__(self, root: str):
        self.paths = sorted(
            os.path.join(root, f) for f in os.listdir(root) if f.endswith(".pkl")
        )
        self._index: List[tuple] = []
        self._cache: Dict[str, list] = {}
        self._lock = threading.Lock()
        self.load_count = 0  # unpickle count (shard-thrash diagnostic)
        self.shard_spans: List[tuple] = []  # (start, end) global idx per shard
        for p in self.paths:
            shard = self._load(p)
            start = len(self._index)
            self._index += [(p, i) for i in range(len(shard))]
            self.shard_spans.append((start, len(self._index)))

    def _load(self, path: str) -> list:
        with self._lock:
            if path not in self._cache:
                self.load_count += 1
                if len(self._cache) >= CACHE_SHARDS:
                    self._cache.pop(next(iter(self._cache)))
                with open(path, "rb") as f:
                    self._cache[path] = pickle.load(f)
            else:  # LRU refresh
                self._cache[path] = self._cache.pop(path)
            return self._cache[path]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> Dict:
        path, i = self._index[idx]
        return self._load(path)[i]


def to_torch(pack):
    """A packer's numpy pack as a PackedBatch, RoiPackedBatch or
    ShardedPack of CPU tensors in their final dtypes (int32 indices widened
    to int64)."""
    return tree_kind(pack).from_numpy(pack)


class PackedLoader:
    """Iterates packed batches; packing runs on background threads.

    Sharding across processes: pass process_index/process_count to give
    each process a disjoint scenario shard (reference DistributedSampler,
    train.py:119-121).

    On a D×G mesh (parallel/windowed_parallel.py) the rank at data row d
    and graph column g passes process_index=d, process_count=D,
    drop_last=True and graph_split=GraphSplit(g, G, sub-config): it fetches
    each group of scen_per_pack scenarios of its row's stride, splits it G
    ways with balance_scenarios and packs only part g, at the subdivided
    capacities. drop_last cuts the shared order to whole groups of every
    row, so every rank takes the same number of steps (the collectives of
    a step would wait forever on a rank that has none).
    """

    def __init__(
        self,
        dataset,
        config: Config,
        shuffle: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        drop_stats: Optional[list] = None,
        packer=None,
        scen_per_pack: Optional[int] = None,
        pack_workers: int = 1,
        to_device: bool = False,
        device=None,
        drop_last: bool = False,
        graph_split=None,
    ):
        """packer: (scenarios, config) → (batch, stats); defaults to the
        LaneGCN pack_batch. For LaneRCNN pass a pack_roi_batch wrapper.

        to_device: yield PackedBatch / RoiPackedBatch trees on `device`
        (default `cuda`; raises without CUDA unless device="cpu") instead
        of the packer's numpy packs. The worker thread converts the pack
        (int32 indices widened to int64 first, so the copy carries the
        final dtypes), then on a card pins each leaf and copies it with
        non_blocking=True on a side stream and records an event; the
        consuming thread makes its current stream wait on that event and
        marks every leaf as used by that stream (record_stream), so the
        caching allocator does not hand a freed batch's memory to the copy
        stream while a step may still read it."""
        self.dataset = dataset
        self.config = config
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.drop_stats = drop_stats
        self.packer = packer or (
            lambda scens, cfg: pack_batch(scens, cfg.pack, cfg.model)
        )
        self.scen_per_pack = scen_per_pack or config.pack.max_scenarios
        self.pack_workers = pack_workers
        self.drop_last = drop_last
        self.graph_split = graph_split
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self._copy_stream = None
        self._lock = threading.Lock()  # the counters below, from the workers
        # Worker-thread seconds spent on host→device transfers (to_device
        # mode: conversion, pinning and issuing the copies), reset per
        # epoch() call; the copies themselves overlap the step in flight.
        self.transfer_s = 0.0
        # Worker-thread seconds spent fetching and packing, reset per epoch.
        self.pack_s = 0.0

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """Epoch scenario order: full Fisher-Yates for in-memory datasets;
        windowed shard-aware shuffle for ShardDataset-like datasets
        (shuffle shard order, then shuffle scenarios within each window of
        CACHE_SHARDS - 1 shards) so a shuffled epoch unpickles each shard
        once instead of thrashing the shard cache on random global access
        (the JAX loader's default window). All processes
        compute the same order from the shared seed, so the strided
        process shards below stay disjoint (reference DistributedSampler,
        train.py:119-121). The same order as the JAX package's loader."""
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + epoch)
        spans = getattr(self.dataset, "shard_spans", None)
        if not self.shuffle:
            order = np.arange(n)
        elif spans and len(spans) > 1:
            window = CACHE_SHARDS - 1
            shard_order = rng.permutation(len(spans))
            parts = []
            for w in range(0, len(shard_order), window):
                idcs = np.concatenate(
                    [np.arange(*spans[s]) for s in shard_order[w : w + window]]
                )
                rng.shuffle(idcs)
                parts.append(idcs)
            order = np.concatenate(parts)
        else:
            order = rng.permutation(n)
        if self.drop_last:
            whole = self.process_count * self.scen_per_pack
            if n < whole:
                raise ValueError(f"{n} scenarios make no whole group of {self.scen_per_pack} "
                                 f"for each of {self.process_count} data rows")
            order = order[: n - n % whole]
        return order[self.process_index :: self.process_count]

    def _groups(self, epoch: int) -> List[List[int]]:
        order = self._epoch_order(epoch)
        spp = self.scen_per_pack
        return [order[i : i + spp].tolist() for i in range(0, len(order), spp)]

    def _transfer(self, pack):
        """The pack as a tree on self.device, and the event its copies end
        at (None off the card)."""
        t0 = time.perf_counter()
        batch = to_torch(pack)
        event = None
        if self._copy_stream is not None:
            with torch.cuda.stream(self._copy_stream):
                batch = batch.map_leaves(
                    lambda t: t.pin_memory().to(self.device, non_blocking=True))
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        else:
            batch = batch.to(self.device)
        with self._lock:
            self.transfer_s += time.perf_counter() - t0
        return batch, event

    def _build(self, group_idcs):
        t0 = time.perf_counter()
        group = [self.dataset[int(i)] for i in group_idcs]
        config = self.config
        if self.graph_split is not None:
            from lanegcn_tpu_torch.parallel.windowed_parallel import split_group

            group, config = split_group(group, self.graph_split), self.graph_split.config
        batch, stats = self.packer(group, config)
        with self._lock:
            self.pack_s += time.perf_counter() - t0
        if self.drop_stats is not None:
            self.drop_stats.append(stats)
        if self.to_device:
            return self._transfer(batch)
        return batch, None

    def _ready(self, batch, event):
        """The consuming side of a transfer: wait for the copies on the
        current stream and keep their memory from the copy stream until
        that stream is done with it."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.leaves():
                t.record_stream(stream)
        return batch

    def epoch(self, epoch: int = 0, skip: int = 0) -> Iterator:
        """Yield the packed batches of one epoch, in order, after its first
        `skip` groups (a resumed run skips the groups it trained already,
        without fetching or packing them).

        pack_workers threads fetch and pack groups ahead of the consumer
        (prefetch + pack_workers groups in flight), order-preserving; the
        packers are numpy with Python loops, so how far more threads help
        is bound by the interpreter lock."""
        groups = iter(self._groups(epoch)[skip:])
        self.transfer_s = 0.0
        self.pack_s = 0.0
        if self.to_device and self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pool = ThreadPoolExecutor(max_workers=max(self.pack_workers, 1))
        try:
            pending = []
            for g in groups:
                pending.append(pool.submit(self._build, g))
                if len(pending) == self.prefetch + self.pack_workers:
                    break
            while pending:
                fut = pending.pop(0)
                g = next(groups, None)
                if g is not None:
                    pending.append(pool.submit(self._build, g))
                yield self._ready(*fut.result())
        finally:
            # A consumer that stops early (preemption) leaves no worker
            # behind: queued groups are cancelled, running ones finish.
            pool.shutdown(wait=True, cancel_futures=True)

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_order(0))
        return max(1, -(-n // self.scen_per_pack))
