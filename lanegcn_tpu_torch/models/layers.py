"""Primitive blocks with the reference's semantics and parameter names.

Layout is channels-last ([N, C] / [N, L, C]), except the 2-D blocks of the
legacy raster path (Conv2dBlock, PostRes), which are NCHW as torch's
Conv2d; parameters keep torch's own layouts (Linear [out, in], Conv1d
[out, in, k], Conv2d [out, in, k, k]) and the reference module
names (`linear`, `norm`, `conv1`, `bn1`, `downsample.0`, ...), so a
reference state_dict loads with strict=True.

Rounding points follow the JAX package: a Dense casts x and its weight to
the compute dtype and adds its bias in that dtype; GroupNorm takes its
statistics in fp32 (biased variance, eps inside the rsqrt) and returns its
input's dtype. Initialization is torch's default, U(±1/sqrt(fan_in)) for
weights and biases, ones/zeros for norm affines, drawn from a
torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lanegcn_tpu_torch.ops import conv1d, group_norm


class _BiasAdd(torch.autograd.Function):
    """y + b, whose backward sums the cotangent's rows in float64. An fp32
    bias gradient is then one rounding of a near-exact sum, the same on the
    card and on the CPU; a plain fp32 sum's rounding depends on the
    reduction's order, and a bias whose gradient cancels by construction
    (the mode score's: the max-margin loss sees only score differences)
    would hold only that order's noise."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b

    @staticmethod
    def backward(ctx, g):
        return g, g.reshape(-1, g.shape[-1]).double().sum(0).to(g.dtype)


class Dense(nn.Module):
    """Bare matmul layer (torch nn.Linear parameters), channels-last. In
    float32 the bias gradient is summed in float64 (`_BiasAdd`)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for p in (self.weight, self.bias):
            if p is not None:
                p.data.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))

    @property
    def kernel(self) -> torch.Tensor:
        """[in, out] view of the weight (the JAX kernel layout)."""
        return self.weight.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.weight.to(self.dtype).t()
        if self.bias is None:
            return y
        if self.dtype == torch.float32:
            return _BiasAdd.apply(y, self.bias.float())
        return y + self.bias.to(self.dtype)


class ConvWeight(nn.Module):
    """Holds a bias-free Conv1d weight [out, in, k], or with dims=2 a Conv2d
    weight [out, in, k, k] (torch nn.Conv1d / nn.Conv2d name)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int, dims: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, *(kernel_size,) * dims))

    def reset_parameters(self, gen: torch.Generator) -> None:
        fan_in = math.prod(self.weight.shape[1:])
        bound = 1.0 / math.sqrt(fan_in)
        self.weight.data.copy_(
            torch.empty(self.weight.shape).uniform_(-bound, bound, generator=gen))


class GroupNorm(nn.Module):
    """GroupNorm(gcd(ng, C), C) with per-channel affine."""

    def __init__(self, c: int, ng: int = 1, eps: float = 1e-5):
        super().__init__()
        self.groups = math.gcd(ng, c)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps).to(x.dtype)


class Linear(nn.Module):
    """Linear(bias=False) + GN + optional ReLU (reference layers.Linear)."""

    def __init__(self, n_in: int, n_out: int, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Dense(n_in, n_out, bias=False, dtype=dtype)
        self.norm = GroupNorm(n_out)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.linear(x))
        return torch.relu(y) if self.act else y


class SplitLinear(Linear):
    """`Linear` over a virtual concatenation, evaluated as a sum of
    per-segment products so that the [E, sum(widths)] concatenation is never
    made (counterpart of lanegcn_tpu/models/layers.py `SplitLinear`).

    The parameters are `Linear(sum(widths), n_out)`'s (`linear.weight`,
    `norm.*`), so state dicts are those of the Linear over the
    concatenation. Each part is (x, gather): x is multiplied by its slice of
    the kernel at its own row count, then `gather` (if not None) maps the
    product rows onto the output rows (an edge gather). The pieces are added
    in the compute dtype in the parts' order, as the JAX package adds them:
    in bf16 the sum rounds after each piece."""

    def __init__(self, widths, n_out: int, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(sum(widths), n_out, act=act, dtype=dtype)
        self.widths = tuple(widths)

    def forward(self, parts) -> torch.Tensor:
        if len(parts) != len(self.widths):
            raise ValueError(f"SplitLinear: {len(parts)} parts for widths {self.widths}")
        kernel, dt = self.linear.kernel, self.linear.dtype
        z, off = None, 0
        for i, ((x, gather), w) in enumerate(zip(parts, self.widths)):
            if x.shape[-1] != w:
                raise ValueError(f"SplitLinear part {i}: width {x.shape[-1]}, declared {w}")
            piece = x.to(dt) @ kernel[off:off + w].to(dt)
            if gather is not None:
                piece = gather(piece)
            z = piece if z is None else z + piece
            off += w
        z = self.norm(z)
        return torch.relu(z) if self.act else z


class LinearRes(nn.Module):
    """Linear residual block (reference layers.LinearRes)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear1 = Dense(n_in, n_out, bias=False, dtype=dtype)
        self.norm1 = GroupNorm(n_out)
        self.linear2 = Dense(n_out, n_out, bias=False, dtype=dtype)
        self.norm2 = GroupNorm(n_out)
        self.transform = (
            nn.Sequential(Dense(n_in, n_out, bias=False, dtype=dtype), GroupNorm(n_out))
            if n_in != n_out else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.linear1(x)))
        y = self.norm2(self.linear2(y))
        if self.transform is not None:
            x = self.transform(x)
        return torch.relu(y + x)


class Conv1dBlock(nn.Module):
    """Conv1d(bias=False) + GN + optional ReLU (reference layers.Conv1d)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int = 3, stride: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvWeight(n_in, n_out, kernel_size)
        self.norm = GroupNorm(n_out)
        self.stride = stride
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(conv1d(x.to(self.dtype), self.conv.weight.to(self.dtype), self.stride))
        return torch.relu(y) if self.act else y


class Res1d(nn.Module):
    """1-D conv residual block (reference layers.Res1d)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int = 3, stride: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvWeight(n_in, n_out, kernel_size)
        self.conv2 = ConvWeight(n_out, n_out, kernel_size)
        self.bn1 = GroupNorm(n_out)
        self.bn2 = GroupNorm(n_out)
        self.downsample = (
            nn.Sequential(ConvWeight(n_in, n_out, 1), GroupNorm(n_out))
            if stride != 1 or n_out != n_in else None
        )
        self.stride = stride
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.bn1(conv1d(x.to(dt), self.conv1.weight.to(dt), self.stride))
        y = torch.relu(y)
        y = self.bn2(conv1d(y, self.conv2.weight.to(dt), 1))
        if self.downsample is not None:
            conv, norm = self.downsample
            x = norm(conv1d(x.to(dt), conv.weight.to(dt), self.stride))
        y = y + x
        return torch.relu(y) if self.act else y


class GroupNorm2d(GroupNorm):
    """GroupNorm on NCHW input: statistics in fp32 over each group's
    channels and the whole map, returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


class Conv2dBlock(nn.Module):
    """Conv2d(bias=False) + GN + optional ReLU (reference layers.Conv2d,
    layers.py:15-37, the legacy raster path). NCHW."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int = 3, stride: int = 1,
                 ng: int = 1, act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvWeight(n_in, n_out, kernel_size, dims=2)
        self.norm = GroupNorm2d(n_out, ng)
        self.stride = stride
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(_conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), self.stride))
        return torch.relu(y) if self.act else y


class PostRes(nn.Module):
    """2-D residual block (reference layers.PostRes, layers.py:91-139, the
    legacy raster path). NCHW; the 1x1 downsample conv and its norm exist
    only where the stride is not 1 or the widths differ."""

    def __init__(self, n_in: int, n_out: int, stride: int = 1, ng: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvWeight(n_in, n_out, 3, dims=2)
        self.conv2 = ConvWeight(n_out, n_out, 3, dims=2)
        self.bn1 = GroupNorm2d(n_out, ng)
        self.bn2 = GroupNorm2d(n_out, ng)
        self.downsample = (
            nn.Sequential(ConvWeight(n_in, n_out, 1, dims=2), GroupNorm2d(n_out, ng))
            if stride != 1 or n_out != n_in else None
        )
        self.stride = stride
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.relu(self.bn1(_conv2d(x.to(dt), self.conv1.weight.to(dt), self.stride)))
        y = self.bn2(_conv2d(y, self.conv2.weight.to(dt), 1))
        if self.downsample is not None:
            conv, norm = self.downsample
            x = norm(_conv2d(x.to(dt), conv.weight.to(dt), self.stride))
        y = y + x
        return torch.relu(y) if self.act else y


class Null(nn.Module):
    """Identity (reference layers.Null, layers.py:241-246)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class EncodeDist(nn.Module):
    """Signed-log distance encoder (reference lanegcn.py:548-572, defined
    but unused by the reference Net): [N, 2] → [N, n] through
    Linear(2, n), ReLU and, with `linear`, Linear(n, n) (`block.0`,
    `block.2`)."""

    def __init__(self, n: int, linear: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        block = [Dense(2, n, dtype=dtype), nn.ReLU()]
        if linear:
            block.append(Dense(n, n, dtype=dtype))
        self.block = nn.Sequential(*block)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        enc = torch.sign(dist) * torch.log(dist.abs() + 1.0)
        return self.block(enc)


def init_parameters(module: nn.Module, seed: int = 0) -> None:
    """Torch-default initialization of every parameter, drawn in module
    order from one seeded torch.Generator (on the CPU, then copied)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters") and isinstance(
                    m, (Dense, ConvWeight, GroupNorm)):
                m.reset_parameters(gen)
