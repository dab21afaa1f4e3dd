"""Rasterized BEV map query, the port's counterpart of
lanegcn_tpu/data/raster.py (the reference's deprecated MapQuery,
data.py:436-506).

The reference loads precomputed city rasters from internal paths and
crops/rotates them per query. This keeps the query's semantics (a 2x
extended crop with autoclip padding, a cartesian flip, a counter-clockwise
rotation about the crop centre with nearest-neighbour sampling, the centre
crop back to the requested region) over rasters the caller provides or
renders from a lane graph, so that ops/roi.py's get_pixel_feat and
get_roi_feat have a map to sample.

Host-side numpy and scipy: data-layer code for the loader; only the sampled
feature maps go to the device.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
from scipy.ndimage import rotate


def _rotate_nearest(img: np.ndarray, theta_deg: float) -> np.ndarray:
    """Counter-clockwise rotation about the image centre, nearest-neighbour,
    same output shape, zeros outside: scipy.ndimage.rotate(order=0,
    reshape=False), as the reference calls it (data.py:503)."""
    if theta_deg % 360 == 0:
        return img.copy()
    return rotate(img, theta_deg, reshape=False, order=0, cval=0.0)


def rasterize_lane_graph(
    ctrs: np.ndarray,  # [N, 2] node centers, world frame
    feats: np.ndarray | None = None,  # [N, 2] segment vectors (optional)
    scale: int = 1,
    pad: float = 4.0,
) -> Dict[str, np.ndarray]:
    """Render lane-centerline nodes into a binary occupancy raster.

    Returns {"map": [H, W] float32 array, "offset": [2] (ox, oy)} such that
    world (x, y) maps to pixel (row=(y+oy)*scale, col=(x+ox)*scale), the
    reference's OFFSET convention (data.py:455-458). Each node paints the
    pixels its segment covers (sampled along `feats` when given)."""
    ctrs = np.asarray(ctrs, np.float64).reshape(-1, 2)
    if feats is not None:
        feats = np.asarray(feats, np.float64).reshape(-1, 2)
        # Sample each segment at 1/scale-meter spacing so lanes are connected.
        ln = np.linalg.norm(feats, axis=1)
        steps = max(2, int(np.ceil(ln.max() * scale)) + 1) if len(ln) else 2
        ts = np.linspace(-0.5, 0.5, steps)
        pts = (ctrs[:, None, :] + ts[None, :, None] * feats[:, None, :]).reshape(-1, 2)
    else:
        pts = ctrs
    ox = pad - pts[:, 0].min() if len(pts) else pad
    oy = pad - pts[:, 1].min() if len(pts) else pad
    w = int(np.ceil((pts[:, 0].max() + ox + pad) * scale)) + 1 if len(pts) else 1
    h = int(np.ceil((pts[:, 1].max() + oy + pad) * scale)) + 1 if len(pts) else 1
    grid = np.zeros((h, w), np.float32)
    cols = np.round((pts[:, 0] + ox) * scale).astype(np.int64)
    rows = np.round((pts[:, 1] + oy) * scale).astype(np.int64)
    keep = (cols >= 0) & (cols < w) & (rows >= 0) & (rows < h)
    grid[rows[keep], cols[keep]] = 1.0
    return {"map": grid, "offset": np.array([ox, oy], np.float64)}


class RasterMapQuery:
    """Crop/rotate queries over city BEV rasters (reference MapQuery
    data.py:436-506, its fixed paths replaced by injected rasters).

    maps/offsets: per-city raster [H, W] and world→pixel offset (ox, oy);
    scale: pixels per meter, one of (1, 2, 4, 8) as in the reference."""

    def __init__(
        self,
        scale: int,
        maps: Mapping[str, np.ndarray],
        offsets: Mapping[str, np.ndarray],
        autoclip: bool = True,
    ):
        assert scale in (1, 2, 4, 8)
        self.scale = scale
        self.autoclip = autoclip
        self.map = {k: np.asarray(v) for k, v in maps.items()}
        self.OFFSET = {k: np.asarray(v, np.float64) for k, v in offsets.items()}
        self.SHAPE = {k: v.shape for k, v in self.map.items()}

    @classmethod
    def from_lane_graph(
        cls,
        ctrs: np.ndarray,
        feats: np.ndarray | None = None,
        scale: int = 1,
        city: str = "MAP",
        autoclip: bool = True,
    ) -> "RasterMapQuery":
        r = rasterize_lane_graph(ctrs, feats, scale=scale)
        return cls(scale, {city: r["map"]}, {city: r["offset"]}, autoclip=autoclip)

    def query(
        self, region: Sequence[float], theta: float = 0.0, city: str = "MAP"
    ) -> np.ndarray:
        """region [x0, x1, y0, y1] world → [(y1-y0)*scale, (x1-x0)*scale]
        crop, rotated counter-clockwise by `theta` degrees (data.py:462-506)."""
        region = [int(x) for x in region]
        map_data = self.map[city]
        offset = self.OFFSET[city]
        shape = self.SHAPE[city]
        x0, x1, y0, y1 = region
        x0, x1 = x0 + offset[0], x1 + offset[0]
        y0, y1 = y0 + offset[1], y1 + offset[1]
        x0, x1, y0, y1 = [int(round(v * self.scale)) for v in (x0, x1, y0, y1)]
        h, w = y1 - y0, x1 - x0
        # Extend the crop 2x for rotation headroom (data.py:481-485).
        x0 -= int(round(w / 2))
        y0 -= int(round(h / 2))
        x1 += int(round(w / 2))
        y1 += int(round(h / 2))
        results = np.zeros((h * 2, w * 2), map_data.dtype)
        xstart, ystart = 0, 0
        if self.autoclip:
            if x0 < 0:
                xstart = -x0
                x0 = 0
            if y0 < 0:
                ystart = -y0
                y0 = 0
            x1 = min(x1, shape[1] - 1)
            y1 = min(y1, shape[0] - 1)
        crop = map_data[y0:y1, x0:x1]
        ch, cw = crop.shape
        results[ystart : ystart + ch, xstart : xstart + cw] = crop
        results = results[::-1]  # flip to cartesian (data.py:501)
        rot = _rotate_nearest(results, theta)
        hh, ww = results.shape
        out_h, out_w = round(hh / 2), round(ww / 2)
        sh, sw = hh // 4, ww // 4
        return rot[sh : sh + out_h, sw : sw + out_w]
