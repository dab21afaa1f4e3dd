"""The port's Argoverse reader (lanegcn_tpu_torch/data/argoverse.py: the csv
module and numpy, no pandas) against the JAX package's (pandas), on CSVs
the tests write from seeds, through pandas' to_csv and through
chip_smoke.py's writer, with the JAX test's StraightMap and chip_smoke.py's
WorldMap (the synthetic worlds' lanes) as maps.

Floats: the port parses with Python's float(), which is correctly rounded.
pandas' default C parser is not: on repr floats it can be off by an ulp or
two at |x| >= 1, and below that by a share of an ulp of 1.0 (many ulps of
x). So read_argo_csv's coordinates must equal the JAX reader's exactly
where both parsers give the same float64 and otherwise lie within 2 ulps
of max(|x|, 1); city, track order and steps must be equal. Everything
downstream of the reader (build_scenario, the dataset, the packers) is
compared exactly: build_scenario on one raw dict given to both, the
datasets on CSVs whose coordinates are multiples of 2^-10, which both
parsers read exactly (asserted first).

The JAX package tries its native helpers first; as in test_torch_data.py
they are switched off here, so both sides run the same numpy paths.
"""

import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import chip_smoke
import lanegcn_tpu.native as jax_native
from lanegcn_tpu.config import ModelConfig as JModelConfig, PackConfig as JPackConfig
from lanegcn_tpu.config import RoiPackConfig as JRoiPackConfig
from lanegcn_tpu.data import argoverse as jax_argo
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.packing_roi import pack_roi_batch as jax_pack_roi_batch
from test_argoverse import StraightMap, _write_csv

from lanegcn_tpu_torch.config import ModelConfig, PackConfig, RoiPackConfig
from lanegcn_tpu_torch.data import argoverse
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
from lanegcn_tpu_torch.data.synthetic import _synthetic_world, make_urban_scenario

REPO = Path(__file__).resolve().parents[1]
CORRIDORS = 2  # worlds small enough that some agents see every lane
ACTORS = 8
QUANT = 2.0 ** -10


@pytest.fixture(autouse=True)
def _numpy_paths(monkeypatch):
    for name in ("dilated_nbrs", "threshold_edges", "cross_edges"):
        monkeypatch.setattr(jax_native, name, lambda *a, **k: None)


def _same(port, ref, path="root"):
    """Exact comparison: dicts, lists, dataclasses, arrays (dtype too), scalars."""
    if isinstance(port, dict):
        assert isinstance(ref, dict) and set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in port:
            _same(port[k], ref[k], f"{path}.{k}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}[{i}]")
    elif dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(port, np.ndarray) or isinstance(ref, np.ndarray):
        a, b = np.asarray(port), np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert port == ref, (path, port, ref)


def _same_read(port, ref):
    """read_argo_csv's output against the JAX reader's: city, order and
    steps equal; coordinates equal where pandas parses as float() does,
    else within 2 ulps of max(|x|, 1) (see the module docstring)."""
    assert port["city"] == ref["city"]
    assert len(port["trajs"]) == len(ref["trajs"])
    for st, rs in zip(port["steps"], ref["steps"]):
        assert st.dtype == np.int64 and np.array_equal(st, rs)
    for tr, rt in zip(port["trajs"], ref["trajs"]):
        assert tr.dtype == np.float64 and tr.shape == rt.shape
        apart = tr != rt
        bound = 2 * np.spacing(np.maximum(np.abs(tr), 1.0))
        assert (np.abs(tr - rt)[apart] <= bound[apart]).all()


def _tracks(rng, ids, types, n=50):
    """(id, type, xy, steps) per track; each track's x starts at 100 * its
    index, so that the order read back names the track."""
    out = []
    for i, (tid, typ) in enumerate(zip(ids, types)):
        t0 = 0 if typ == "AGENT" else int(rng.integers(0, 15))
        steps = np.arange(t0, n)
        xy = np.stack([100.0 * i + np.cumsum(rng.uniform(0.1, 1.5, len(steps))),
                       rng.normal(0, 3, len(steps))], 1)
        out.append((tid, typ, xy, steps))
    return out


def _write_pandas(path, tracks, city=True, shuffle=True):
    """The JAX test's writer (pandas to_csv, shuffled rows), or without the
    CITY_NAME column, or in track order."""
    if city and shuffle:
        return _write_csv(path, tracks)
    rows = [{"TIMESTAMP": 315968222.0 + 0.1 * s, "TRACK_ID": tid, "OBJECT_TYPE": typ,
             "X": x, "Y": y, **({"CITY_NAME": "MIA"} if city else {})}
            for tid, typ, xy, steps in tracks for (x, y), s in zip(xy, steps)]
    pd.DataFrame(rows).to_csv(path, index=False)


def _case_csv(tmp_path, case):
    rng = np.random.default_rng(list(CASES).index(case))
    path = str(tmp_path / f"{case}.csv")
    if case == "uuid":  # chip_smoke.py's writer: UUID IDs, shuffled rows, repr floats
        tracks = _tracks(rng, range(6), ["AGENT"] + ["OTHERS"] * 5)
        chip_smoke.write_argo_csv(path, [t[2] for t in tracks], [t[3] for t in tracks],
                                  "PIT", seed=5)
    elif case == "int_ids":  # all integers: the keys sort as numbers, 9 before 10
        _write_pandas(path, _tracks(rng, [10, 9, 100, 2, 33], ["OTHERS", "AGENT", "AV",
                                                                 "OTHERS", "OTHERS"]))
    elif case == "agent_last":  # string IDs, the AGENT's rows last in the file
        _write_pandas(path, _tracks(rng, ["b", "a", "zz", "c"], ["OTHERS", "AV", "OTHERS",
                                                                  "AGENT"]), shuffle=False)
    elif case == "mixed_ids":  # one non-integer ID: every key sorts as a string
        _write_pandas(path, _tracks(rng, ["10", "9", "x1", "2"], ["AGENT", "OTHERS", "OTHERS",
                                                                  "AV"]))
    else:  # no CITY_NAME column: city ""
        _write_pandas(path, _tracks(rng, ["q", "p"], ["AGENT", "OTHERS"]), city=False)
    return path


# case: the order of the tracks read back, by their index in _tracks.
CASES = {"uuid": None, "int_ids": [1, 3, 0, 4, 2], "agent_last": [3, 1, 0, 2],
         "mixed_ids": [0, 3, 1, 2], "no_city": [0, 1]}


@pytest.mark.parametrize("case", list(CASES))
def test_read_argo_csv_matches_pandas(tmp_path, case):
    path = _case_csv(tmp_path, case)
    port, ref = argoverse.read_argo_csv(path), jax_argo.read_argo_csv(path)
    _same_read(port, ref)
    assert port["city"] == {"agent_last": "MIA", "no_city": ""}.get(case, "PIT")
    order = CASES[case] or list(range(6))  # chip_smoke's IDs sort in track order
    assert [int(t[0, 0] // 100) for t in port["trajs"]] == order
    assert all(s.min() >= 0 and s.max() == 49 for s in port["steps"][:1])


@pytest.mark.parametrize("which", ["straight", "world"])
def test_build_scenario_matches(tmp_path, which):
    if which == "straight":  # the JAX test's CSV and map
        t = np.arange(50)
        _write_csv(str(tmp_path / "1.csv"), [
            ("av-1", "AV", np.stack([t * 0.5, np.full(50, 3.5)], 1), t),
            ("agent-1", "AGENT", np.stack([t * 1.0, np.zeros(50)], 1), t)])
        path, mp, scales = str(tmp_path / "1.csv"), StraightMap(), 3
    else:
        path = chip_smoke.write_world_csv(str(tmp_path), 7, CORRIDORS, ACTORS)
        mp, scales = chip_smoke.WorldMap(CORRIDORS), 6
    raw = argoverse.read_argo_csv(path)
    port = argoverse.build_scenario(raw, mp, num_scales=scales)
    ref = jax_argo.build_scenario(copy.deepcopy(raw), mp, num_scales=scales)
    _same(port, ref)
    assert port["graph"]["num_nodes"] > 0 and port["feats"].shape[0] >= 2


def _quantized_dir(root, seeds_by_name):
    """CSVs of the worlds' actors with coordinates on a 2^-10 grid, named by
    the mapping's keys; both readers must read them exactly."""
    os.makedirs(root, exist_ok=True)
    for name, seed in seeds_by_name.items():
        _, trajs, steps = _synthetic_world(seed, CORRIDORS, ACTORS, urban=True)
        trajs = [np.round(t / QUANT) * QUANT for t in trajs]
        path = os.path.join(root, f"{name}.csv")
        chip_smoke.write_argo_csv(path, trajs, steps, f"SYN{seed}", seed)
        _same(argoverse.read_argo_csv(path), jax_argo.read_argo_csv(path))
    return root


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Per with_rois: the port's and the JAX package's dataset items, over
    CSVs with numeric stems (12, 40) and a non-numeric one."""
    root = _quantized_dir(str(tmp_path_factory.mktemp("argo")),
                          {"12": 12, "40": 40, "scene_a": 3})
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("dilated_nbrs", "threshold_edges", "cross_edges"):
            mp.setattr(jax_native, name, lambda *a, **k: None)
        for rois in (False, True):
            port = argoverse.ArgoScenarioDataset(root, chip_smoke.WorldMap(CORRIDORS),
                                                 with_rois=rois)
            ref = jax_argo.ArgoScenarioDataset(root, chip_smoke.WorldMap(CORRIDORS),
                                               with_rois=rois)
            out[rois] = ([port[i] for i in range(len(port))], [ref[i] for i in range(len(ref))])
    return out


@pytest.mark.parametrize("rois", [False, True], ids=["scenarios", "rois"])
def test_dataset_matches(datasets, rois):
    port, ref = datasets[rois]
    assert len(port) == 3
    _same(port, ref)
    # Paths sort as strings; a numeric stem is the seq_id, else the index.
    assert [it["seq_id"] for it in port] == [12, 40, 2]
    assert [it["city"] for it in port] == ["SYN12", "SYN40", "SYN3"]
    assert ("subgraphs" in port[0]) == rois


def test_pack_batch_matches(datasets):
    port, ref = datasets[False]
    got, got_stats = pack_batch(port, PackConfig(max_scenarios=3), ModelConfig())
    want, want_stats = jax_pack_batch(ref, JPackConfig(max_scenarios=3), JModelConfig())
    assert got_stats == want_stats and got_stats["packed_scenarios"] == 3
    _same(got, want)


ROI_PACK = dict(max_scenarios=3, max_rois=48, max_interest_nodes=1024, max_edges_scale0=1024,
                max_edges_dilated=2048, max_edges_lr=1024, max_a2m_edges=2048,
                max_pool_edges=32768, max_a2r_edges=4096, max_roi_nodes=4096,
                max_global_nodes=2048)


def test_pack_roi_batch_matches(datasets):
    port, ref = datasets[True]
    got, got_stats = pack_roi_batch(copy.deepcopy(port), RoiPackConfig(**ROI_PACK),
                                    ModelConfig())
    want, want_stats = jax_pack_roi_batch(copy.deepcopy(ref), JRoiPackConfig(**ROI_PACK),
                                          JModelConfig())
    assert got_stats == want_stats and got_stats["packed_scenarios"] == 3
    assert not {k: v for k, v in got_stats.items() if k.startswith(("dropped", "graph_dropped"))
                and v}
    _same(got, want)


def test_csv_matches_make_urban_scenario(tmp_path):
    """CSV → scenario against make_urban_scenario of the same seed: the
    actor features always; the whole dict (city aside) where no lane of the
    world was left out."""
    actor_keys = ("feats", "ctrs", "orig", "theta", "rot", "gt_preds", "has_preds",
                  "obs_trajs")
    wmap = chip_smoke.WorldMap(CORRIDORS)
    ds_root = str(tmp_path)
    for seed in range(16):
        chip_smoke.write_world_csv(ds_root, seed, CORRIDORS, ACTORS)
    ds = argoverse.ArgoScenarioDataset(ds_root, wmap)
    whole = 0
    for i in range(len(ds)):
        got = ds[i]
        seed = got["seq_id"]
        want = make_urban_scenario(seed, num_corridors=CORRIDORS, num_actors=ACTORS)
        for k in actor_keys:
            _same(got[k], want[k], k)
        if len(np.unique(got["graph"]["lane_idcs"])) == len(wmap.world(got["city"])):
            _same({k: v for k, v in got.items() if k != "city"},
                  {k: v for k, v in want.items() if k != "city"})
            whole += 1
    assert whole >= 2, whole


_NO_PANDAS = """
import json, sys
sys.modules["pandas"] = None
import chip_smoke
from lanegcn_tpu_torch.data.argoverse import ArgoScenarioDataset
ds = ArgoScenarioDataset(sys.argv[1], chip_smoke.WorldMap(int(sys.argv[2])), with_rois=True)
items = [ds[i] for i in range(len(ds))]
loaded = sorted(m.split(".")[0] for m, v in sys.modules.items() if v is not None)
print(json.dumps({"pandas": "pandas" in loaded,
                  "items": [[it["seq_id"], int(it["graph"]["num_nodes"]),
                             float(abs(it["feats"]).sum()), len(it["subgraphs"])]
                            for it in items]}))
"""


def test_reader_runs_without_pandas(tmp_path):
    root = str(tmp_path)
    chip_smoke.write_world_csv(root, 5, CORRIDORS, ACTORS)
    chip_smoke.write_world_csv(root, 6, CORRIDORS, ACTORS)
    proc = subprocess.run([sys.executable, "-c", _NO_PANDAS, root, str(CORRIDORS)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    ds = argoverse.ArgoScenarioDataset(root, chip_smoke.WorldMap(CORRIDORS), with_rois=True)
    want = [[it["seq_id"], int(it["graph"]["num_nodes"]), float(abs(it["feats"]).sum()),
             len(it["subgraphs"])] for it in (ds[0], ds[1])]
    assert res == {"pandas": False, "items": want}


def test_argoverse_map_provider_is_gated(tmp_path):
    """Without the argoverse-api package the map adapter, and a dataset
    built without a map, raise ImportError, as the JAX package's do."""
    if importlib.util.find_spec("argoverse") is not None:
        pytest.skip("argoverse-api is installed")
    with pytest.raises(ImportError):
        argoverse.ArgoverseMapProvider()
    with pytest.raises(ImportError):
        argoverse.ArgoScenarioDataset(str(tmp_path))
    with pytest.raises(ImportError):
        jax_argo.ArgoverseMapProvider()
