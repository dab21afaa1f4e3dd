"""Per-rank seeds and metric sums across ranks, the port's counterpart of
lanegcn_tpu/parallel/multihost.py (the reference's per-rank seeding,
train.py:55-59, and its MPI allgather of metric sums, train.py:245-255).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def process_seed(base_seed: int) -> int:
    """This rank's data seed (the rotation augment's): base + rank."""
    return base_seed + (dist.get_rank() if dist.is_initialized() else 0)


def sync_metric_sums(metrics: Dict[str, float], group=None) -> Dict[str, float]:
    """Scalar metric sums added over the ranks of `group` (default: every
    rank) in fp64, on the host (one gloo all_reduce; every rank must pass
    the same keys). Without a process group, the sums as they are."""
    if not dist.is_initialized():
        return dict(metrics)
    keys = sorted(metrics)
    vals = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(vals, group=group)
    return dict(zip(keys, vals.tolist()))
