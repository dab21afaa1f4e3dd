"""Small utilities (reference utils.py:13-34), the port's copy of
lanegcn_tpu/utils/misc.py."""

from __future__ import annotations

from typing import Dict

import numpy as np


def index_dict(data: Dict, idcs) -> Dict:
    """Select rows idcs from every value (reference utils.py:13-17)."""
    return {k: v[idcs] for k, v in data.items()}


def rotate(xy: np.ndarray, theta: np.ndarray) -> np.ndarray:
    """Per-row 2-D rotation (reference utils.py:20-28). xy: [N, 2],
    theta: [N] radians."""
    st, ct = np.sin(theta), np.cos(theta)
    rot = np.stack(
        [np.stack([ct, -st], -1), np.stack([st, ct], -1)], axis=1
    )  # [N, 2, 2]
    return np.einsum("nij,nj->ni", rot, xy)


def merge_dict(src: Dict, dst: Dict) -> None:
    """Copy src entries into dst (reference utils.py:31-34)."""
    for key in src:
        dst[key] = src[key]
