"""Agent-centric scenario featurization (reference data.py:148-217).

Given world-frame trajectories with per-point timestep indices, produce the
agent-centric training features: origin = AGENT position at the last observed
step, rotation chosen so the agent's last heading maps to π, per-actor motion
deltas with validity masks, and world-frame ground-truth futures.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def featurize_scenario(
    trajs: Sequence[np.ndarray],
    steps: Sequence[np.ndarray],
    num_hist: int = 20,
    num_pred: int = 30,
    pred_range: Sequence[float] = (-100.0, 100.0, -100.0, 100.0),
    theta: float | None = None,
) -> Dict[str, np.ndarray]:
    """trajs[i]: [P_i, 2] world xy; steps[i]: [P_i] int timesteps in [0, 50).

    trajs[0] is the AGENT and must contain step num_hist-1. Actors missing the
    last observed step, or whose last observed position falls outside
    pred_range, are dropped (reference data.py:162-199). Histories are made
    contiguous: leading points with gaps before them are discarded.
    """
    agent_traj, agent_step = np.asarray(trajs[0], np.float64), np.asarray(steps[0])
    t_last = num_hist - 1
    assert t_last in agent_step, "AGENT must be observed at the last history step"
    orig = agent_traj[list(agent_step).index(t_last)].astype(np.float32)

    if theta is None:
        prev_idx = list(agent_step).index(t_last - 1) if (t_last - 1) in agent_step else None
        if prev_idx is None:
            theta = 0.0
        else:
            pre = agent_traj[prev_idx] - orig
            theta = float(np.pi - np.arctan2(pre[1], pre[0]))
    rot = np.asarray(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], np.float32
    )

    feats, ctrs, gt_preds, has_preds, obs_trajs = [], [], [], [], []
    x_min, x_max, y_min, y_max = pred_range
    for traj, step in zip(trajs, steps):
        traj = np.asarray(traj, np.float64)
        step = np.asarray(step, np.int64)
        if t_last not in step:
            continue

        gt_pred = np.zeros((num_pred, 2), np.float32)
        has_pred = np.zeros(num_pred, bool)
        future_mask = np.logical_and(step >= num_hist, step < num_hist + num_pred)
        gt_pred[step[future_mask] - num_hist] = traj[future_mask]
        has_pred[step[future_mask] - num_hist] = True

        obs_mask = step < num_hist
        step_o = step[obs_mask]
        traj_o = traj[obs_mask]
        idcs = step_o.argsort()
        step_o, traj_o = step_o[idcs], traj_o[idcs]
        # Keep only the contiguous tail ending at t_last (reference data.py:181-185).
        for i in range(len(step_o)):
            if step_o[i] == t_last - (len(step_o) - 1) + i:
                break
        step_o, traj_o = step_o[i:], traj_o[i:]

        feat = np.zeros((num_hist, 3), np.float32)
        feat[step_o, :2] = np.matmul(rot, (traj_o - orig.reshape(-1, 2)).T).T
        feat[step_o, 2] = 1.0

        if not (x_min <= feat[-1, 0] <= x_max and y_min <= feat[-1, 1] <= y_max):
            continue

        obs_trajs.append(feat.copy())  # agent-frame absolute positions
        ctrs.append(feat[-1, :2].copy())
        feat[1:, :2] -= feat[:-1, :2]
        feat[step_o[0], :2] = 0
        feats.append(feat)
        gt_preds.append(gt_pred)
        has_preds.append(has_pred)

    return {
        "feats": np.asarray(feats, np.float32).reshape(-1, num_hist, 3),
        "ctrs": np.asarray(ctrs, np.float32).reshape(-1, 2),
        "orig": orig,
        "theta": np.float32(theta),
        "rot": rot,
        "gt_preds": np.asarray(gt_preds, np.float32).reshape(-1, num_pred, 2),
        "has_preds": np.asarray(has_preds, bool).reshape(-1, num_pred),
        "obs_trajs": np.asarray(obs_trajs, np.float32).reshape(-1, num_hist, 3),
    }
