"""Tensor ops of the port: plain PyTorch primitives and the wrappers of the
hand-written CUDA kernels (each wrapper runs its plain version on CPU
tensors and launches its kernel on CUDA tensors)."""

from lanegcn_tpu_torch.ops.conv import conv1d, interpolate_linear  # noqa: F401
from lanegcn_tpu_torch.ops.norm import group_norm  # noqa: F401
from lanegcn_tpu_torch.ops.scatter import masked_gather, scatter_add, segment_softmax  # noqa: F401
