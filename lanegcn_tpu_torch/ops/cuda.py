"""Building, loading and counting the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` for `sm_90a` into a
shared library with a plain C interface under `build/lanegcn_tpu_torch/`
(beside the package's source tree), then loaded with ctypes. The library
name carries a hash of the sources, so an edited kernel is rebuilt and a
built one is reused. `build_all` starts one `nvcc` per source at once.

Every C entry point returns `cudaGetLastError()` after its launch; `call`
raises when that is not 0, so a refused launch never passes silently.

`LAUNCHES` counts launches per C entry point (`lane_layer_fwd`,
`lane_layer_bwd`, ..., `window_scatter_bwd`, `segment_sum`, `lane_plan_fwd`,
`lane_plan_bwd`, `band_conv_fwd`, `band_conv_bwd`): `call` adds one where
it launches the entry, and nothing else does. An entry may run several kernels (a backward's passes and its
partial-sum reductions); it counts once per call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

# C entry points of each kernel library.
ENTRIES = {
    "lane_layer": ("lane_layer_fwd", "lane_layer_bwd"),
    "scenario_agg": ("scenario_agg_fwd", "scenario_agg_bwd"),
    "win_edge": ("win_edge_fwd", "win_edge_bwd"),
    "row_tail": ("row_tail_fwd", "row_tail_bwd", "row_tail2_fwd", "row_tail2_bwd"),
    "pair_agg": ("pair_agg_fwd", "pair_agg_bwd"),
    "edge_mlp": ("edge_mlp_fwd", "edge_mlp_bwd", "edge_mlp_pool_fwd", "edge_mlp_pool_bwd"),
    "window_scatter": ("window_scatter_fwd", "window_scatter_bwd"),
    "segment_sum": ("segment_sum",),
    "lane_plan": ("lane_plan_fwd", "lane_plan_bwd"),
    "band_conv": ("band_conv_fwd", "band_conv_bwd"),
}

KERNELS = tuple(ENTRIES)

# The row widths each C entry point is built at (csrc/common.cuh `with_width`;
# `with_width_dtype_256` for the entries that also take 256: the double-width
# LaneGCN's three forwards, on csrc/wide.cuh's tiling, and their backwards, on
# csrc/wide_bwd.cuh's); segment_sum takes any width. Each wrapper refuses the
# others (`check_width`).
WIDTHS = {e: (64, 128) for entries in ENTRIES.values() for e in entries
          if e != "segment_sum"}
WIDTHS.update({e: (64, 128, 256) for e in ("lane_layer_fwd", "lane_layer_bwd", "row_tail_fwd",
                                            "row_tail_bwd", "edge_mlp_fwd", "edge_mlp_bwd")})

LAUNCHES: Dict[str, int] = {e: 0 for entries in ENTRIES.values() for e in entries}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "lanegcn_tpu_torch"
_LIBS: Dict[str, ctypes.CDLL] = {}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, object]:
    """Build (in parallel) and load the named kernels' libraries.

    Returns {"seconds": wall time, "ptxas": {name: nvcc -Xptxas -v log}}.
    """
    t0 = time.perf_counter()
    names = list(names)
    jobs = {name: _start_build(name) for name in names}
    logs = {name: _finish_build(name, job) for name, job in jobs.items()}
    for name in names:
        lib(name)
    return {"seconds": time.perf_counter() - t0, "ptxas": logs}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    if name not in _LIBS:
        path = _lib_path(name)
        if not path.exists():
            _finish_build(name, _start_build(name))
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device | None = None) -> ctypes.c_void_p:
    """PyTorch's current stream on `device` (default: the current device),
    as the kernels take it: the raw handle, without a Stream object."""
    idx = device.index if device is not None else None
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx))


def call(name: str, entry: str, *args) -> None:
    """Launch one C entry of kernel library `name` and count the entry.

    Arguments are ctypes values (c_void_p for pointers, c_int, c_float);
    raises if the entry reports a CUDA error. The entry's argument types are
    set at its first call (ctypes keeps the function object on the library).
    """
    fn = getattr(lib(name), entry)
    if fn.argtypes is None:
        fn.argtypes = [type(a) for a in args]
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} from {entry}")
    LAUNCHES[entry] = LAUNCHES.get(entry, 0) + 1


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def entry_of(name: str) -> str:
    """The C entry point behind kernel `name` as the wrappers' messages name
    it: `lane_layer` → lane_layer_fwd, `lane_layer_bwd` → itself."""
    return name if name.endswith("_bwd") else f"{name}_fwd"


def check_width(name: str, c: int) -> None:
    """Raise a ValueError naming kernel `name` and the width c where its C
    entry is not built at rows c wide (before anything touches the card)."""
    widths = WIDTHS[entry_of(name)]
    if c not in widths:
        raise ValueError(f"{name}: the kernel takes rows {' or '.join(map(str, widths))} "
                         f"wide, not {c}")


_SMS: Dict[int, int] = {}


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card: the block count of the
    backward passes that keep one parameter-gradient partial per block
    (read once per device)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def param(t: torch.Tensor, dtype: torch.dtype = torch.float32, align: int = 16) -> torch.Tensor:
    """A parameter as a kernel reads it: contiguous, in `dtype`, its data
    `align`-byte aligned (16 for the kernels' float4 loads; a kernel that
    reads the vector element by element passes the element size). Under
    the flat optimizer every parameter is a view into one buffer at its own
    offset (a 5-float bias shifts all later ones by 4 bytes), so it is
    copied when it is not aligned."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def check_cuda(name: str, *tensors: torch.Tensor | None) -> int:
    """Validate the tensors a kernel reads (None, an absent optional input,
    is skipped); returns the first tensor's dtype code."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device}, {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
    code = DTYPE_CODE.get(tensors[0].dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {tensors[0].dtype} not supported (float32, bfloat16)")
    return code
