"""Model registry: the port's counterpart of lanegcn_tpu/models/registry.py.

`get_model(name, config)` returns a ModelBundle: the config (LaneRCNN's
with its optimizer promoted to AdamW, as the JAX registry does), the net
on its device, and the family's loss, metrics and extract functions, so a
caller builds the train and eval steps without knowing the family:

    bundle = get_model("lanercnn", cfg, dtype=torch.bfloat16)
    net, state = init_state(bundle.config, net=bundle.net)
    step = make_train_step(bundle.config, net, state, loss_fn=bundle.loss_fn,
                           metrics_fn=bundle.metrics_fn)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from lanegcn_tpu_torch.config import Config


@dataclasses.dataclass
class ModelBundle:
    name: str
    config: Config
    net: Any  # nn.Module taking a packed batch
    loss_fn: Callable  # (out, batch, loss_cfg) → dict with "loss" + sums
    metrics_fn: Callable  # (out, batch) → metric sums
    # (out, batch) → (preds [n, K, T, 2], gts [n, T, 2], probs [n, K]) numpy,
    # for eval / submission; probs = softmax of the per-mode confidences.
    extract_fn: Callable = None


_REGISTRY: Dict[str, Callable[..., ModelBundle]] = {}


def register(name: str):
    def deco(factory: Callable[..., ModelBundle]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_model(name: str, config: Config | None = None, dtype: torch.dtype = torch.float32,
              device=None, seed: int | None = None) -> ModelBundle:
    """The named model's bundle; its net computes in `dtype` over fp32
    params drawn from `seed` (default config.train.seed), on `device`
    (default `cuda`; raises without CUDA unless device="cpu")."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    config = config or Config()
    seed = config.train.seed if seed is None else seed
    return _REGISTRY[name](config, dtype=dtype, device=device, seed=seed)


def available() -> list:
    return sorted(_REGISTRY)


def _softmax(x: np.ndarray) -> np.ndarray:
    z = np.exp(x - x.max(axis=-1, keepdims=True))
    return z / z.sum(axis=-1, keepdims=True)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _extract_lanegcn(out, batch):
    mask = _np(batch.scen_mask)
    idx = _np(batch.agent_idx)[mask]
    probs = _softmax(_np(out["cls"])[idx])
    return _np(out["reg"])[idx], _np(batch.gt_preds)[idx], probs


def _extract_lanercnn(out, batch):
    mask = _np(batch.scen_mask)
    probs = _softmax(_np(out["pred_logics"])[mask])
    return _np(out["pred_trajs"])[mask], _np(batch.gt_preds)[mask], probs


@register("lanegcn")
def _lanegcn(config: Config, **net_kw) -> ModelBundle:
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN, agent_metrics, pred_loss

    return ModelBundle(name="lanegcn", config=config, net=LaneGCN(config.model, **net_kw),
                       loss_fn=pred_loss, metrics_fn=agent_metrics,
                       extract_fn=_extract_lanegcn)


@register("lanercnn")
def _lanercnn(config: Config, **net_kw) -> ModelBundle:
    """LaneRCNN trains with AdamW and weight decay 0.01 (reference
    lanercnn.py:37,42): a plain Adam config without decay is promoted, as
    lanegcn_tpu/models/registry.py:97-100 does; it takes RoiPackedBatch
    inputs."""
    from lanegcn_tpu_torch.models.lanercnn import LaneRCNN, roi_loss, roi_metrics

    if config.train.opt == "adam" and config.train.weight_decay == 0.0:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, opt="adamw", weight_decay=0.01))
    return ModelBundle(name="lanercnn", config=config, net=LaneRCNN(config.model, **net_kw),
                       loss_fn=roi_loss, metrics_fn=roi_metrics,
                       extract_fn=_extract_lanercnn)
