"""Argoverse-style forecasting metrics and the submission table: the port's
copy of lanegcn_tpu/eval.py (numpy only).

Equivalent of the reference's test.py:101-109 eval flow, which calls
`argoverse.evaluation.eval_forecasting.compute_forecasting_metrics` for K=6
and K=1: per sequence, minADE = min over modes of mean displacement, minFDE =
min over modes of final displacement, MR = fraction of sequences whose
min-FDE mode misses the endpoint by > threshold.

Note the reference's *training-log* metrics (pred_metrics lanegcn.py:883-899)
differ slightly: there `ade` is the ADE of the min-FDE mode. Both are
provided (`log_style=True` reproduces the training-log variant).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def forecasting_metrics(
    preds: np.ndarray,  # [B, K, T, 2]
    gts: np.ndarray,  # [B, T, 2]
    k: int = 6,
    miss_threshold: float = 2.0,
    log_style: bool = False,
) -> Dict[str, float]:
    """Official-semantics minADE/minFDE/MR over the top-k modes.

    Modes are assumed confidence-descending (PredNet sorts them), so top-k
    slicing matches the reference's K=1 evaluation of the best-scored mode.
    """
    preds = np.asarray(preds, np.float64)[:, :k]
    gts = np.asarray(gts, np.float64)
    err = np.sqrt(((preds - gts[:, None, :, :]) ** 2).sum(-1))  # [B, K, T]
    ade_per_mode = err.mean(-1)  # [B, K]
    fde_per_mode = err[:, :, -1]  # [B, K]

    if log_style:
        # Training-log variant: mode chosen by min FDE, ADE of that mode.
        min_idcs = fde_per_mode.argmin(1)
        rows = np.arange(len(preds))
        min_ade = ade_per_mode[rows, min_idcs].mean()
        min_fde = fde_per_mode[rows, min_idcs].mean()
        mr = (fde_per_mode[rows, min_idcs] > miss_threshold).mean()
    else:
        min_ade = ade_per_mode.min(1).mean()
        min_fde = fde_per_mode.min(1).mean()
        mr = (fde_per_mode.min(1) > miss_threshold).mean()
    return {
        f"minADE_{k}": float(min_ade),
        f"minFDE_{k}": float(min_fde),
        f"MR_{k}": float(mr),
    }


def evaluate_predictions(
    preds: np.ndarray, gts: np.ndarray, miss_threshold: float = 2.0
) -> Dict[str, float]:
    """The reference eval report: K=6 and K=1 (test.py:101-109)."""
    out = {}
    out.update(forecasting_metrics(preds, gts, k=6, miss_threshold=miss_threshold))
    out.update(forecasting_metrics(preds, gts, k=1, miss_threshold=miss_threshold))
    return out


def forecasting_metric_sums(
    preds: np.ndarray, gts: np.ndarray, miss_threshold: float = 2.0
) -> Dict[str, float]:
    """Metric *sums* for a later reduction: sum over the given sequences of
    the K=6/K=1 per-sequence minADE/minFDE/miss terms plus 'count'. Sum
    them over parts (the reference reduces metric dicts across ranks with
    MPI allgather, train.py:245-255), then normalize with
    metrics_from_sums."""
    out = {"count": float(len(preds))}
    if len(preds) == 0:
        for k in (6, 1):
            out.update({f"minADE_{k}": 0.0, f"minFDE_{k}": 0.0, f"MR_{k}": 0.0})
        return out
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    err = np.sqrt(((preds - gts[:, None, :, :]) ** 2).sum(-1))  # [B, K, T]
    for k in (6, 1):
        ade = err[:, :k].mean(-1).min(1)
        fde = err[:, :k, -1].min(1)
        out[f"minADE_{k}"] = float(ade.sum())
        out[f"minFDE_{k}"] = float(fde.sum())
        out[f"MR_{k}"] = float((fde > miss_threshold).sum())
    return out


def metrics_from_sums(sums: Dict[str, float]) -> Dict[str, float]:
    """Normalize globally-reduced metric sums into the eval report."""
    n = max(sums.get("count", 0.0), 1e-10)
    return {k: v / n for k, v in sums.items() if k != "count"}


def write_submission(
    path: str,
    preds: np.ndarray,  # [B, K, T, 2] world frame
    seq_ids: np.ndarray,  # [B] scenario ids
    probabilities: np.ndarray | None = None,  # [B, K]
) -> None:
    """Competition submission file (reference test.py:110-113 uses
    argoverse's generate_forecasting_h5). Writes the same layout: one
    [B*K*T, 5] table of (seq_id, mode, x, y, probability) rows under
    'argoverse_forecasting', h5 when h5py is available, else .npz."""
    preds = np.asarray(preds, np.float32)
    b, k, t = preds.shape[0], preds.shape[1], preds.shape[2]
    if probabilities is None:
        probabilities = np.full((b, k), 1.0 / k, np.float32)
    rows = np.zeros((b * k * t, 5), np.float32)
    rows[:, 0] = np.repeat(np.asarray(seq_ids, np.float32), k * t)
    rows[:, 1] = np.tile(np.repeat(np.arange(k, dtype=np.float32), t), b)
    rows[:, 2:4] = preds.reshape(-1, 2)
    rows[:, 4] = np.repeat(np.asarray(probabilities, np.float32).reshape(-1), t)
    try:
        import h5py

        with h5py.File(path if path.endswith(".h5") else path + ".h5", "w") as f:
            f.create_dataset("argoverse_forecasting", data=rows, compression="gzip")
    except ImportError:
        np.savez_compressed(
            path if path.endswith(".npz") else path + ".npz",
            argoverse_forecasting=rows,
        )
