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
    "win_edge": ("win_edge_fwd", "win_edge_bwd_d", "win_edge_bwd_s"),
    "row_tail": ("row_tail_fwd", "row_tail_bwd", "row_tail2_fwd", "row_tail2_bwd"),
    "pair_agg": ("pair_agg_fwd", "pair_agg_bwd_d", "pair_agg_bwd_s"),
    "edge_mlp": ("edge_mlp_fwd", "edge_mlp_bwd", "edge_mlp_pool_fwd", "edge_mlp_pool_bwd"),
    "window_scatter": ("window_scatter_fwd", "window_scatter_bwd"),
    "segment_sum": ("segment_sum",),
    "lane_plan": ("lane_plan_fwd", "lane_plan_bwd"),
    "band_conv": ("band_conv_fwd", "band_conv_bwd"),
}

KERNELS = tuple(ENTRIES)

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


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def call(name: str, entry: str, *args) -> None:
    """Launch one C entry of kernel library `name` and count the entry.

    Arguments are ctypes values (c_void_p for pointers, c_int, c_float);
    raises if the entry reports a CUDA error.
    """
    fn = getattr(lib(name), entry)
    fn.argtypes = [type(a) for a in args]
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} from {entry}")
    LAUNCHES[entry] += 1


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card: the block count of the
    backward passes that keep one parameter-gradient partial per block."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def param(t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A parameter as a kernel reads it: contiguous, in `dtype`, its data
    16-byte aligned for the kernels' float4 loads. Under the flat optimizer
    every parameter is a view into one buffer at its own offset (a 5-float
    bias shifts all later ones by 4 bytes), so it is copied when it is not
    aligned."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Validate the tensors a kernel reads; returns the activation dtype code."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices ({t.device}, {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
    dt = tensors[0].dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dt} not supported (float32, bfloat16)")
    return DTYPE_CODE[dt]
