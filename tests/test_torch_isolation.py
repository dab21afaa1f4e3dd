"""The port stands alone: importing every module of `lanegcn_tpu_torch` pulls
in neither JAX (nor flax / optax) nor any module of the JAX package, and the
port's entry points run on CUDA unless the caller asks for the CPU — without
CUDA they raise instead of falling back quietly."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lanegcn_tpu_torch.config import Config
from lanegcn_tpu_torch.device import resolve_device
from lanegcn_tpu_torch.data.packing import window_chunked_edges
from lanegcn_tpu_torch.graph import EdgeSet
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.models.lanercnn import LaneRCNN
from lanegcn_tpu_torch.models.registry import get_model
from lanegcn_tpu_torch.parallel.mesh import init_mesh
from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import lanegcn_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(lanegcn_tpu_torch.__path__,
                                                      "lanegcn_tpu_torch."))
for name in names:
    importlib.import_module(name)
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "lanegcn_tpu"))
print(json.dumps({"modules": names, "banned": banned}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    # Every layer of the slice was imported, down to the kernel wrappers.
    for name in ("lanegcn_tpu_torch.ops.lane_layer", "lanegcn_tpu_torch.ops.scenario_agg",
                 "lanegcn_tpu_torch.ops.win_edge", "lanegcn_tpu_torch.ops.row_tail",
                 "lanegcn_tpu_torch.ops.pair_agg", "lanegcn_tpu_torch.ops.edge_mlp",
                 "lanegcn_tpu_torch.ops.window_scatter", "lanegcn_tpu_torch.ops.scatter",
                 "lanegcn_tpu_torch.ops.segment_sum", "lanegcn_tpu_torch.ops.band_conv",
                 "lanegcn_tpu_torch.data.packing", "lanegcn_tpu_torch.data.packing_roi",
                 "lanegcn_tpu_torch.data.lane_roi", "lanegcn_tpu_torch.models.lanercnn",
                 "lanegcn_tpu_torch.models.registry",
                 "lanegcn_tpu_torch.train.loop", "lanegcn_tpu_torch.train.optimizer",
                 "lanegcn_tpu_torch.utils.weights", "lanegcn_tpu_torch.cli",
                 "lanegcn_tpu_torch.eval", "lanegcn_tpu_torch.data.dataset",
                 "lanegcn_tpu_torch.data.augment", "lanegcn_tpu_torch.train.checkpoint",
                 "lanegcn_tpu_torch.train.preempt", "lanegcn_tpu_torch.utils.logger",
                 "lanegcn_tpu_torch.utils.profiling", "lanegcn_tpu_torch.parallel",
                 "lanegcn_tpu_torch.parallel.mesh", "lanegcn_tpu_torch.parallel.multihost",
                 "lanegcn_tpu_torch.parallel.windowed_parallel",
                 "lanegcn_tpu_torch.parallel.graph_shard",
                 "lanegcn_tpu_torch.parallel.graph_parallel"):
        assert name in res["modules"], name
    assert res["banned"] == [], res["banned"]


def test_gpu_scripts_import_no_jax():
    """chip_smoke.py, tree_profile.py, pack_draws.py and mesh_draws.py,
    beside every port module, import neither JAX nor the JAX package."""
    probe = _PROBE + """
import chip_smoke, tree_profile, pack_draws, mesh_draws
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "lanegcn_tpu"))
print(json.dumps({"banned": banned}))
"""
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"banned": []}


@pytest.fixture
def no_cuda(monkeypatch):
    """The entry points' view of a machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["resolve_device", "LaneGCN", "LaneRCNN", "make_eval_step",
                                   "init_state", "make_train_step", "get_model", "init_mesh"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    cfg = Config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "resolve_device":
            resolve_device()
        elif entry == "LaneGCN":
            LaneGCN(cfg.model)
        elif entry == "LaneRCNN":
            LaneRCNN(cfg.model)
        elif entry == "make_eval_step":
            make_eval_step(cfg, torch.nn.Linear(1, 1))
        elif entry == "init_state":
            init_state(cfg)
        elif entry == "get_model":
            get_model("lanercnn", cfg)
        elif entry == "init_mesh":
            init_mesh()
        else:
            make_train_step(cfg, torch.nn.Linear(1, 1), None)
    # Asking for the CPU is the one way to run them here.
    assert resolve_device("cpu").type == "cpu"


def test_window_chunked_edge_set_is_not_dst_sorted():
    """A window-chunked list carries the source-side inverse, as a
    destination-sorted one does, but its padding sits between windows, so
    it must not claim to be destination-sorted; the same edges padded flat
    and sorted do."""
    u = np.array([5, 700, 3, 900, 5, 260])
    v = np.arange(6)
    chunked = EdgeSet.from_numpy(window_chunked_edges(u, v, 2048, 256, 6)[0])
    assert chunked.inv_perm is not None and chunked.win_lu is not None
    assert not chunked.dst_sorted
    mask = chunked.mask.numpy()
    assert not mask[: mask.sum()].all()  # a padding hole before the last edge
    flat = EdgeSet(u=chunked.u, v=chunked.v, mask=chunked.mask, inv_perm=chunked.inv_perm,
                   inv_dst=chunked.inv_dst)
    assert flat.dst_sorted
