"""LaneGCN in PyTorch: layers, ActorNet, MapNet, fusion, PredNet, the Net."""

from lanegcn_tpu_torch.models.layers import Conv1dBlock, Linear, LinearRes, Res1d  # noqa: F401
