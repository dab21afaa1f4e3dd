"""lanegcn_tpu_torch — the LaneGCN and LaneRCNN lane-graph forecasters in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `lanegcn_tpu` (which stays the reference): the
same packed, static-shape batches (graph.PackedBatch, graph.RoiPackedBatch),
the same modules, and the same parameter names as the reference torch
LaneGCN and LaneRCNN, so a reference checkpoint's state_dict loads with
strict=True. Entry points run
on `cuda` unless the caller passes device="cpu"; on a CPU tensor every
kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
