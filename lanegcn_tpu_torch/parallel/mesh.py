"""The D×G process layout of the multi-GPU trainer on torch.distributed,
and its two collectives with a gradient: the port's counterpart of
lanegcn_tpu/parallel/sharding.py `make_mesh`/`make_mesh_2d` and
lanegcn_tpu/parallel/multihost.py `initialize_distributed`.

One process (rank) per card. `torch.distributed.run` starts them and sets
RANK, WORLD_SIZE and LOCAL_RANK; rank r sits at data row d = r // G and
graph column g = r % G, on `cuda:LOCAL_RANK`. Each data row's G ranks share
one group of scenarios (`graph_group`); each graph column's D ranks see
the same column of every row (`data_group`).

The backend is NCCL on cards and gloo on the CPU. gloo on CUDA tensors is
the test mode of several ranks on one card (NCCL refuses two ranks on one
device): it must be asked for, and NCCL with two ranks on one card raises
instead of switching backends quietly.

Over the graph row, as torch.autograd.Functions, each the other's
gradient (the JAX VJPs):
- `gather_union` is the JAX `all_gather(..., tiled=True)`: forward, the G
  ranks' rows in column order; backward, the reduce-scatter of the
  cotangent, which sums the G identical cotangents of a replicated loss
  (lanegcn_tpu/parallel/windowed_parallel.py:292-295) at this rank's rows;
- `reduce_scatter_rows` is the JAX `psum_scatter(..., tiled=True)`:
  forward, the sum of the G ranks' [G·n, ...] partials at this rank's n
  rows; backward, the all-gather of the cotangent.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Dict

import torch
import torch.distributed as dist

from lanegcn_tpu_torch.device import resolve_device


def parse_mesh(spec: str) -> tuple:
    """'D' or 'DxG' → (D, G)."""
    parts = spec.lower().split("x")
    if len(parts) not in (1, 2) or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh takes D or DxG with positive integers, not {spec!r}")
    return int(parts[0]), int(parts[1]) if len(parts) == 2 else 1


@dataclasses.dataclass
class Mesh:
    """This rank's place in a D×G layout, its device, its groups, and the
    collectives it has issued (`counts`: calls and bytes by kind)."""

    data: int
    graph: int
    rank: int
    device: torch.device
    backend: str
    graph_group: Any
    data_group: Any
    # Host-side flags (the preemption flag): a gloo group over every rank,
    # so a flag never waits on the card's stream.
    control_group: Any
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.data * self.graph

    @property
    def d(self) -> int:
        return self.rank // self.graph

    @property
    def g(self) -> int:
        return self.rank % self.graph

    def count(self, kind: str, nbytes: int) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.counts[kind + "_bytes"] = self.counts.get(kind + "_bytes", 0) + int(nbytes)


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def init_mesh(data: int | None = None, graph: int = 1, device=None, backend: str | None = None,
              init_method: str | None = None, rank: int | None = None,
              world_size: int | None = None) -> Mesh:
    """Join (or start) the process group and build this rank's Mesh.

    rank and world_size default to torch.distributed.run's RANK and
    WORLD_SIZE (0 and 1 without them), data to world_size // graph; D·G
    must equal the world size. The process group starts from `init_method`
    (e.g. 'tcp://localhost:PORT'), else from torch.distributed.run's
    environment (MASTER_ADDR), else, for one rank alone, from an in-process
    store; one already started is joined.

    device defaults to `cuda:LOCAL_RANK` (raises without CUDA; "cpu" for
    the CPU), backend to "nccl" on a card and "gloo" on the CPU.
    """
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = _env_int("RANK", 0) if rank is None else rank
        world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    data = world_size // graph if data is None else data
    if data * graph != world_size:
        raise ValueError(f"a {data}x{graph} mesh needs {data * graph} ranks; "
                         f"the world has {world_size}")
    local_rank = _env_int("LOCAL_RANK", rank)
    if device is None:
        device = resolve_device("cuda")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} takes card {local_rank}; this machine has "
                               f"{torch.cuda.device_count()}")
        device = torch.device("cuda", local_rank)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on cards; the CPU takes backend='gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if init_method is not None:
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size)
        elif "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, rank=rank, world_size=world_size)
        elif world_size == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            raise RuntimeError("several ranks need an init_method or torch.distributed.run's "
                               "environment (MASTER_ADDR, RANK, WORLD_SIZE)")
    control = dist.new_group(backend="gloo")
    if backend == "nccl":
        # Every rank's card, on the host: NCCL would fail (or hang) later.
        cards = [None] * world_size
        dist.all_gather_object(cards, (socket.gethostname(), device.index), group=control)
        if len(set(cards)) != len(cards):
            raise RuntimeError(f"NCCL cannot run two ranks on one card {cards}; "
                               "give each rank a card of its own, or pass backend='gloo' "
                               "(the test mode of several ranks on one card)")
    graph_group = data_group = None
    # Every rank creates every group, in the same order.
    for d in range(data):
        grp = dist.new_group([d * graph + g for g in range(graph)])
        if d == rank // graph:
            graph_group = grp
    for g in range(graph):
        grp = dist.new_group([d * graph + g for d in range(data)])
        if g == rank % graph:
            data_group = grp
    return Mesh(data=data, graph=graph, rank=rank, device=device, backend=backend,
                graph_group=graph_group, data_group=data_group, control_group=control)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # all_gather_single is all_gather_into_tensor's newer name.
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # reduce_scatter_single is reduce_scatter_tensor's newer name.
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[G·n, ...]: the graph row's x, in column order (no gradient)."""
    x = x.contiguous()
    out = x.new_empty((mesh.graph * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x, mesh.graph_group)
    mesh.count("all_gather", out.numel() * out.element_size())
    return out


def sum_scatter_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[n, ...]: the sum over the graph row of each rank's x [G·n, ...], at
    this rank's rows (no gradient); counted with x's bytes."""
    x = x.contiguous()
    if x.shape[0] % mesh.graph:
        raise ValueError(f"reduce-scatter of {x.shape[0]} rows over {mesh.graph} ranks")
    out = x.new_empty((x.shape[0] // mesh.graph,) + tuple(x.shape[1:]))
    _reduce_scatter(out, x, mesh.graph_group)
    mesh.count("reduce_scatter", x.numel() * x.element_size())
    return out


class _GatherUnion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return sum_scatter_rows(grad, ctx.mesh), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return sum_scatter_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return all_gather_rows(grad, ctx.mesh), None


def gather_union(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The graph row's x in column order, [G·n, ...]; its gradient is the
    sum of the G ranks' cotangents at this rank's rows."""
    return _GatherUnion.apply(x, mesh)


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the graph row of each rank's x [G·n, ...], at this
    rank's n rows; its gradient is the graph row's cotangents gathered in
    column order."""
    return _ReduceScatterRows.apply(x, mesh)


def destroy() -> None:
    """End the process group (a no-op when none was started)."""
    if dist.is_initialized():
        dist.destroy_process_group()
