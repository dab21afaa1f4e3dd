"""Rotation augmentation (reference data.py:39-65, config["rot_aug"]), the
port's copy of lanegcn_tpu/data/augment.py.

Re-rotates a featurized scenario by a random extra angle dt: actor motion
deltas, centers, and the lane graph rotate by R(-dt); the stored world
transform (theta, rot) absorbs +dt so world-frame ground truth stays valid.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rotate_scenario(data: Dict, dt: float) -> Dict:
    """Return a new scenario dict rotated by dt (radians)."""
    theta = float(data["theta"]) + dt
    new = {k: data[k] for k in ("city", "orig", "gt_preds", "has_preds") if k in data}
    new["theta"] = np.float32(theta)
    new["rot"] = np.asarray(
        [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]], np.float32
    )

    rot = np.asarray(
        [[np.cos(-dt), -np.sin(-dt)], [np.sin(-dt), np.cos(-dt)]], np.float32
    )
    feats = data["feats"].copy()
    feats[:, :, :2] = np.matmul(feats[:, :, :2], rot)
    new["feats"] = feats
    new["ctrs"] = np.matmul(data["ctrs"], rot)
    if "obs_trajs" in data:
        obs = data["obs_trajs"].copy()
        obs[:, :, :2] = np.matmul(obs[:, :, :2], rot)
        new["obs_trajs"] = obs

    graph = dict(data["graph"])
    graph["ctrs"] = np.matmul(data["graph"]["ctrs"], rot)
    graph["feats"] = np.matmul(data["graph"]["feats"], rot)
    new["graph"] = graph
    return new


class RotationAugment:
    """Dataset wrapper applying a random rotation per sample
    (rot_size defaults to 2π as in the reference)."""

    def __init__(self, dataset, rot_size: float = 2.0 * np.pi, seed: int = 0):
        self.dataset = dataset
        self.rot_size = rot_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng((self.seed, idx))
        return rotate_scenario(self.dataset[idx], float(rng.random() * self.rot_size))
