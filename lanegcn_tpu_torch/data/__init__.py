"""Host-side data pipeline (numpy/scipy): featurization, lane-graph
construction, synthetic scenarios, the Argoverse reader, the raster query
and packing into static-shape batches.

The names below load their module on first use, so that importing a
numpy-only module of the package (a process that only reads CSVs or makes
scenarios) does not import torch, which the packers' batch trees need.
"""

import importlib

_EXPORTS = {
    "featurize_scenario": "featurize",
    "build_lane_graph": "lane_graph",
    "pack_batch": "packing",
    "RasterMapQuery": "raster",
    "rasterize_lane_graph": "raster",
    "make_synthetic_scenario": "synthetic",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
