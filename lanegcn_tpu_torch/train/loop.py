"""The eval step and metric accumulation (reference train.py val loop).

`make_eval_step` is the port's serving entry point: forward, then
pred_loss, then agent_metrics, on one packed batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from lanegcn_tpu_torch.config import Config
from lanegcn_tpu_torch.device import resolve_device
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.lanegcn import agent_metrics, pred_loss


def make_eval_step(config: Config, net, device=None) -> Callable:
    """Returns fn(batch) → (out, metrics).

    The step runs on `device` (default `cuda`; raises without CUDA unless
    device="cpu"), moves `net` there, and accepts a PackedBatch on any
    device or with numpy leaves (as the packer returns it).
    """
    device = resolve_device(device)
    net.to(device).eval()

    @torch.no_grad()
    def eval_step(batch) -> tuple:
        if not isinstance(batch, PackedBatch) or not isinstance(batch.rot, torch.Tensor):
            batch = PackedBatch.from_numpy(batch)
        batch = batch.to(device)
        out = net(batch)
        metrics = dict(pred_loss(out, batch, config.loss))
        metrics.update(agent_metrics(out, batch))
        return out, metrics

    return eval_step


class MetricAccumulator:
    """Running sums of loss/metric components, normalized at display time."""

    def __init__(self):
        self.sums: Dict[str, float] = {}

    def update(self, metrics: Dict[str, Any]):
        for k, v in metrics.items():
            if k in ("loss", "lr"):
                continue
            self.sums[k] = self.sums.get(k, 0.0) + float(v)

    def summary(self) -> Dict[str, float]:
        s = self.sums
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
