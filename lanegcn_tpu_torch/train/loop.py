"""Train and eval steps, metric accumulation and the training loop
(reference train.py:161-255; the port's counterpart of
lanegcn_tpu/train/loop.py).

`make_eval_step` is the serving entry point: forward, then the loss, then
the metrics (LaneGCN's pred_loss and agent_metrics by default, LaneRCNN's
roi_loss and roi_metrics when given), on one packed batch.
`make_train_step` adds the backward (through the kernels' hand-written
backward passes) and the flat Adam(W) or SGD step with the StepLR schedule
and the NaN guard; it takes the same loss_fn and metrics_fn, and, on a
mesh, the collectives of parallel/windowed_parallel.py.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from lanegcn_tpu_torch.config import Config
from lanegcn_tpu_torch.device import resolve_device
from lanegcn_tpu_torch.graph import ShardedPack, tree_kind
from lanegcn_tpu_torch.models.lanegcn import LaneGCN, agent_metrics, pred_loss
from lanegcn_tpu_torch.train.optimizer import FlatOptimizer, make_optimizer


def _on_device(batch, device):
    """A PackedBatch, RoiPackedBatch or ShardedPack on `device`, from one
    of those or the packers' numpy packs (either framework's)."""
    kind = tree_kind(batch)
    pack = batch.pack if kind is ShardedPack else batch
    if not isinstance(batch, kind) or not isinstance(pack.scen_mask, torch.Tensor):
        batch = kind.from_numpy(batch)
    return batch.to(device)


class TrainState:
    """The optimizer (flat params, moments, count), the lr schedule and the
    step counter. The parameters themselves live in the net, as views of
    the optimizer's flat buffer."""

    def __init__(self, opt: FlatOptimizer, lr_fn: Callable, step: int = 0):
        self.opt = opt
        self.lr_fn = lr_fn
        self.step = step


def init_state(config: Config, net=None, dtype=torch.float32,
               device=None) -> Tuple[torch.nn.Module, TrainState]:
    """`net` (a LaneGCN or a LaneRCNN, e.g. with loaded weights) or, by
    default, a LaneGCN (compute dtype `dtype`, fp32 params initialised from
    config.train.seed) on `device` (default `cuda`; raises without CUDA
    unless device="cpu"), and its TrainState."""
    device = resolve_device(device)
    if net is None:
        net = LaneGCN(config.model, dtype=dtype, device=device, seed=config.train.seed)
    net.to(device)
    opt, lr_fn = make_optimizer(config.train, net)
    return net, TrainState(opt, lr_fn)


def make_train_step(config: Config, net, state: TrainState, device=None, loss_fn=None,
                    metrics_fn=None, comm=None, forward=None) -> Callable:
    """Returns fn(batch, epoch) → metrics.

    One step: forward, loss_fn (default pred_loss; LaneRCNN: roi_loss),
    backward, then the flat optimizer's update at lr_fn(epoch) (fractional
    epoch). Where the JAX step returns new params and optimizer state, this
    one updates `net`'s parameters and `state` in place. The metrics are
    device tensors (no host sync): the losses, metrics_fn's (default
    agent_metrics; LaneRCNN: roi_metrics), `lr`, and `skipped` (1 when the
    NaN guard dropped the update) when config.train.nan_guard is set.

    `comm` (a parallel.windowed_parallel.WindowedComm) makes it one rank's
    step of a D×G mesh: the loss and metrics are taken on
    comm.union(out, batch), the union of the graph row's outputs and loss
    fields; comm.reduce_metrics averages the loss over the data column and
    sums the rest; comm.reduce_grad averages the flat gradient over every
    rank before the guard and the update. `forward`: fn(batch) → outputs
    in place of net(batch) (the explicit graph-parallel step's sharded
    forward over net's modules, parallel/graph_parallel.py).
    """
    device = resolve_device(device)
    net.to(device).train()
    guard = config.train.nan_guard
    loss_fn = loss_fn or pred_loss
    metrics_fn = metrics_fn or agent_metrics
    forward = forward or net

    def train_step(batch, epoch) -> Dict[str, torch.Tensor]:
        batch = _on_device(batch, device)
        for p in state.opt.params:
            p.grad = None
        out = forward(batch)
        if comm is not None:
            out, batch = comm.union(out, batch)
        losses = loss_fn(out, batch, config.loss)
        losses["loss"].backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        with torch.no_grad():
            metrics.update(metrics_fn({k: v.detach() for k, v in out.items()}, batch))
        if comm is not None:
            metrics = comm.reduce_metrics(metrics)
        lr = state.lr_fn(epoch, device)
        ok = state.opt.step(lr, metrics["loss"] if guard else None,
                            reduce=None if comm is None else comm.reduce_grad)
        if guard:
            metrics["skipped"] = 1.0 - ok.float()
        metrics["lr"] = lr
        state.step += 1
        return metrics

    return train_step


def make_eval_step(config: Config, net, device=None, loss_fn=None,
                   metrics_fn=None) -> Callable:
    """Returns fn(batch) → (out, metrics): the forward, loss_fn (default
    pred_loss) and metrics_fn (default agent_metrics), as the JAX
    package's make_eval_step takes them (LaneRCNN: roi_loss, roi_metrics).

    The step runs on `device` (default `cuda`; raises without CUDA unless
    device="cpu"), moves `net` there, and accepts a PackedBatch or a
    RoiPackedBatch on any device or with numpy leaves (as the packers
    return them).
    """
    device = resolve_device(device)
    net.to(device).eval()
    loss_fn = loss_fn or pred_loss
    metrics_fn = metrics_fn or agent_metrics

    @torch.no_grad()
    def eval_step(batch) -> tuple:
        batch = _on_device(batch, device)
        out = net(batch)
        metrics = dict(loss_fn(out, batch, config.loss))
        metrics.update(metrics_fn(out, batch))
        return out, metrics

    return eval_step


class MetricAccumulator:
    """Running sums of loss/metric components, normalized at display time.

    A device metric is summed as an fp64 tensor on its device, so `update`
    makes no host sync; `summary` converts once. fp32 values widened to
    fp64 and added in the same order give bitwise the sums of Python
    floats."""

    def __init__(self):
        self.sums: Dict[str, Any] = {}

    def update(self, metrics: Dict[str, Any]):
        for k, v in metrics.items():
            if k in ("loss", "lr"):
                continue
            v = v.detach().double() if isinstance(v, torch.Tensor) else float(v)
            self.sums[k] = self.sums.get(k, 0.0) + v

    def host_sums(self) -> Dict[str, float]:
        """The running sums as Python floats (one host sync)."""
        keys = [k for k, v in self.sums.items() if isinstance(v, torch.Tensor)]
        out = {k: v for k, v in self.sums.items() if k not in keys}
        if keys:
            out.update(zip(keys, torch.stack([self.sums[k] for k in keys]).tolist()))
        return out

    def summary(self) -> Dict[str, float]:
        s = self.host_sums()
        eps = 1e-10
        out = {
            "cls": s.get("cls_loss", 0.0) / (s.get("num_cls", 0.0) + eps),
            "reg": s.get("reg_loss", 0.0) / (s.get("num_reg", 0.0) + eps),
        }
        out["loss"] = out["cls"] + out["reg"]
        n = s.get("num_scen", 0.0) + eps
        out["ade1"] = s.get("ade1_sum", 0.0) / n
        out["fde1"] = s.get("fde1_sum", 0.0) / n
        out["ade"] = s.get("ade_sum", 0.0) / n
        out["fde"] = s.get("fde_sum", 0.0) / n
        out["mr"] = s.get("mr_sum", 0.0) / n
        return out

    def reset(self):
        self.sums = {}


def train_epochs(
    config: Config,
    net,
    state: TrainState,
    batches: Iterable,
    num_steps: int,
    steps_per_epoch: int,
    log_every: int = 50,
    log_fn=print,
    device=None,
    loss_fn=None,
    metrics_fn=None,
) -> Tuple[TrainState, Dict[str, float]]:
    """Simple single-process loop over an iterable of packed batches; the
    epoch passed to each step is step / steps_per_epoch; loss_fn and
    metrics_fn as make_train_step takes them."""
    train_step = make_train_step(config, net, state, device, loss_fn, metrics_fn)
    acc = MetricAccumulator()
    t0 = time.time()
    for batch in batches:
        if state.step >= num_steps:
            break
        epoch = state.step / max(steps_per_epoch, 1)
        metrics = train_step(batch, epoch)
        acc.update(metrics)
        if state.step % log_every == 0:
            s = acc.summary()
            log_fn(
                f"step {state.step} epoch {epoch:.3f} lr {float(metrics['lr']):.5f} "
                f"loss {s['loss']:.4f} cls {s['cls']:.4f} reg {s['reg']:.4f} "
                f"ade {s['ade']:.4f} fde {s['fde']:.4f} ({time.time() - t0:.1f}s)"
            )
    return state, acc.summary()
