"""The port's windowed data×graph step (lanegcn_tpu_torch/parallel/) on two
gloo ranks on the CPU, against the single-device step in this process
(and, marked slow: 4 ranks at D=2×G=2, the JAX package's windowed step,
and the CLI's `train --mesh` under torch.distributed.run with a bitwise
resume).

One torch.multiprocessing spawn of 2 ranks runs, for LaneGCN and LaneRCNN
at a few channels, one SGD step (lr 0.1, momentum trace) from one seeded
init on each layout:
- D=1×G=2: each rank a balanced half of one 4-scenario group at the
  subdivided capacities; the reference is the single-device step on the
  union pack (the halves' scenarios in column order, at the full capacities);
- D=2×G=1: each rank a whole pack of its own; the reference is the mean of
  the single-device losses and gradients of the two packs.
The loss, the support counts, the flat gradient (each rank's local
gradient, averaged over the ranks as the step's all_reduce does) and the
parameter update after SGD are checked against the reference; both ranks
must hold the same parameters. Then a NaN in rank 1's input alone makes
every rank skip the update, on both layouts.
"""

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig, RoiPackConfig, TrainConfig
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
from lanegcn_tpu_torch.data.synthetic import make_roi_scenario, make_synthetic_scenario
from lanegcn_tpu_torch.graph import PackedBatch, RoiPackedBatch
from lanegcn_tpu_torch.models.registry import get_model
from lanegcn_tpu_torch.parallel import windowed_parallel as wp
from lanegcn_tpu_torch.parallel.mesh import init_mesh
from lanegcn_tpu_torch.train.loop import init_state, make_train_step

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2)
PACK = dict(max_scenarios=4, max_actors=64, actor_stride=16, max_nodes=2048, node_stride=256,
            max_plan_edges=512, max_edges_scale0=512, max_edges_dilated=768, max_edges_lr=256,
            max_a2m_edges=2048, max_m2a_edges=2048, max_a2a_edges=1024, fusion_pairs=True,
            table_relations=())
ROI_PACK = dict(max_scenarios=4, max_rois=32, max_roi_nodes=2048, node_stride=256,
                max_plan_edges=512, max_global_nodes=1536, global_node_stride=256,
                global_plan_edges=1024, max_interest_nodes=512, max_edges_scale0=1024,
                max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=1024,
                max_pool_edges=16384, max_a2r_edges=2048, table_relations=())
TRAIN = TrainConfig(opt="sgd", lr=(0.1,), lr_epochs=())
CASES = [(fam, d, g) for fam in ("lanegcn", "lanercnn") for d, g in ((1, 2), (2, 1))]
NAN_CASES = [("lanegcn", 1, 2), ("lanegcn", 2, 1)]
# The loss within rtol 1e-4 (as tests/test_windowed_parallel.py): both sides
# compute the same fp32 terms, on sub-packs or the union pack (other row
# counts in each product and other orders in the loss's sums: ~1e-6).
LOSS_RTOL = 1e-4
# The flat gradient and the SGD update, elementwise within
# GRAD_TOL · (rms(reference) + |reference|): the parameter gradients sum
# the same per-row terms over other partitions and orders (rows of two
# sub-packs, or of two packs averaged), ~1e-6 of their scale; a gradient
# scale off by G, or a missed rank, is off by ~100 % of it.
GRAD_TOL = 1e-4


def _config(family):
    return Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK),
                  roi_pack=RoiPackConfig(**ROI_PACK), train=TRAIN)


def _bundle(family):
    return get_model(family, _config(family), device="cpu", seed=7)


def _scens(family, seed0, n=4):
    if family == "lanercnn":
        return [make_roi_scenario(seed=seed0 + i, num_corridors=1, num_actors=4)
                for i in range(n)]
    return [make_synthetic_scenario(seed=seed0 + i, num_corridors=2, num_actors=8)
            for i in range(n)]


def _pack(family, scens, config):
    if family == "lanercnn":
        b, st = pack_roi_batch(scens, config.roi_pack, config.model)
    else:
        b, st = pack_batch(scens, config.pack, config.model)
    bad = {k: v for k, v in st.items()
           if k.startswith(("dropped", "graph_dropped", "skipped")) and v}
    assert st["packed_scenarios"] == len(scens) and not bad, st
    return b


def _inputs(family, d, g):
    """(each rank's pack, the reference packs): D=1×G=2 the two balanced
    halves and their union; D=2×G=1 two packs, each its own reference."""
    config = _config(family)
    if g == 1:
        packs = [_pack(family, _scens(family, 100 * (r + 1)), config) for r in range(d)]
        return packs, packs
    scens = _scens(family, 300)
    split = wp.graph_split(config, _FakeMesh(g), family)
    parts = wp.balance_scenarios(scens, g, max_per_group=len(scens) // g)
    subs = [_pack(family, [scens[i] for i in grp], split.config) for grp in parts]
    union = _pack(family, [scens[i] for grp in parts for i in grp], config)
    return subs, [union]


@dataclasses.dataclass
class _FakeMesh:
    graph: int
    g: int = 0


def _flat_grad(net):
    return torch.cat([p.grad.reshape(-1) for p in net.parameters()])


def _rank_main(rank, port, path, world=2):
    torch.set_num_threads(1)
    inputs = torch.load(path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    out = {}
    for key, case in inputs.items():
        _, family, d, g = key
        mesh = init_mesh(d, g, device="cpu")
        bundle = _bundle(family)
        if "weights" in case:
            bundle.net.load_state_dict(case["weights"])
        cfg = bundle.config
        net, state = init_state(cfg, net=bundle.net, device="cpu")
        step = wp.make_windowed_parallel_train_step(cfg, net, state, mesh, "cpu",
                                                    bundle.loss_fn, bundle.metrics_fn)
        before = state.opt.flat.clone()
        m = step(case["packs"][rank], 0.0)
        out[key] = dict(metrics={k: float(v) for k, v in m.items()}, grad=_flat_grad(net),
                        before=before, after=state.opt.flat.clone(), counts=dict(mesh.counts))
    torch.save(out, f"{path}.rank{rank}")
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(inputs, tmp, world=2):
    """Each rank's step on inputs {(what, family, D, G): {"packs": [one a
    rank], "weights": optional state dict}}, on `world` spawned gloo ranks;
    the ranks' results."""
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    mp.start_processes(_rank_main, args=(_free_port(), path, world), nprocs=world, join=True,
                       start_method="spawn")
    return [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(world)]


def _reference(family, packs):
    """The single-device step from the same init on each pack: the mean
    loss, the other metrics summed (the loss sums, the support counts, the
    ADE/FDE/MR sums), the mean flat gradient and the SGD update on that
    mean."""
    losses, grads, counts = [], [], {}
    for b in packs:
        bundle = _bundle(family)
        net, state = init_state(bundle.config, net=bundle.net, device="cpu")
        m = make_train_step(bundle.config, net, state, "cpu", bundle.loss_fn,
                            bundle.metrics_fn)(b, 0.0)
        losses.append(float(m["loss"]))
        grads.append(_flat_grad(net))
        for k, v in m.items():
            if k not in ("loss", "lr", "skipped"):
                counts[k] = counts.get(k, 0.0) + float(v)
    grad = torch.stack(grads).mean(0)
    bundle = _bundle(family)
    net, state = init_state(bundle.config, net=bundle.net, device="cpu")
    before = state.opt.flat.clone()
    state.opt.step(state.lr_fn(0.0, "cpu"), reduce=lambda g: grad.clone())
    return dict(loss=float(np.mean(losses)), counts=counts, grad=grad,
                update=state.opt.flat - before)


def _close(got, want, what):
    tol = GRAD_TOL * (want.square().mean().sqrt() + want.abs())
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"{what}: max err {float(err.max())}, " \
        f"worst over tolerance {float((err / tol).max())}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(1)
    # Keyed (what, family, D, G): each rank's input.
    inputs, refs = {}, {}
    for case in CASES:
        ranks, ref_packs = _inputs(*case)
        kind = RoiPackedBatch if case[0] == "lanercnn" else PackedBatch
        inputs[("step",) + case] = {"packs": [kind.from_numpy(p) for p in ranks]}
        refs[case] = _reference(case[0], ref_packs)
    for case in NAN_CASES:
        packs = list(inputs[("step",) + case]["packs"])
        feats = packs[1].actors.feats.clone()
        feats[0, 0, 0] = float("nan")
        packs[1] = dataclasses.replace(
            packs[1], actors=dataclasses.replace(packs[1].actors, feats=feats))
        inputs[("nan",) + case] = {"packs": packs}
    return _spawn_ranks(inputs, tmp_path_factory.mktemp("mesh")), refs


@pytest.mark.parametrize("case", CASES, ids=[f"{f}-{d}x{g}" for f, d, g in CASES])
def test_windowed_step_matches_the_single_device_step(run, case):
    ranks, refs = run
    ref = refs[case]
    family, d, g = case
    for r in ranks:
        got = r[("step",) + case]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["loss"], rtol=LOSS_RTOL)
        for k, v in ref["counts"].items():
            if k.startswith("num_"):  # support counts: exact
                assert got["metrics"][k] == v, (k, got["metrics"][k], v)
            else:  # loss and metric sums: fp32 sums, as the loss
                np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert got["metrics"]["skipped"] == 0.0
        _close(got["after"] - got["before"], ref["update"], f"{case} SGD update")
    # Every rank holds the same parameters after the step.
    r0, r1 = (r[("step",) + case] for r in ranks)
    assert torch.equal(r0["after"], r1["after"])
    # The ranks' local gradients, averaged as the step's all_reduce does.
    _close((r0["grad"] + r1["grad"]) / 2, ref["grad"], f"{case} gradient")
    # Collectives a step: the two gathers and the cotangent's reduce-scatter
    # over the graph row, the metrics' and the gradient's all_reduce.
    counts = r0["counts"]
    assert counts["all_gather"] == 2 and counts["reduce_scatter"] == 1, counts
    assert counts["all_reduce"] == 2, counts
    assert counts["all_reduce_bytes"] > 4 * ref["grad"].numel()


@pytest.mark.parametrize("case", NAN_CASES, ids=[f"{f}-{d}x{g}" for f, d, g in NAN_CASES])
def test_nan_on_one_rank_skips_every_rank(run, case):
    ranks, _ = run
    for r in ranks:
        got = r[("nan",) + case]
        assert got["metrics"]["skipped"] == 1.0
        assert not np.isfinite(got["metrics"]["loss"])
        assert torch.equal(got["after"], got["before"])


@pytest.mark.slow
def test_four_rank_2x2_step_matches_the_mean_of_the_rows_unions(tmp_path):
    """D=2×G=2 on 4 gloo ranks (LaneGCN): each data row one group of 4
    split in two balanced halves; the reference is the mean of the two
    rows' single-device steps on their union packs. Checks as the two-rank
    cases; every rank holds the same parameters."""
    config = _config("lanegcn")
    split = wp.graph_split(config, _FakeMesh(2), "lanegcn")
    packs, unions = [], []
    for d in range(2):
        scens = _scens("lanegcn", 500 + 10 * d)
        parts = wp.balance_scenarios(scens, 2, max_per_group=2)
        packs += [_pack("lanegcn", [scens[i] for i in grp], split.config) for grp in parts]
        unions.append(_pack("lanegcn", [scens[i] for grp in parts for i in grp], config))
    key = ("step", "lanegcn", 2, 2)
    ranks = _spawn_ranks({key: {"packs": [PackedBatch.from_numpy(p) for p in packs]}},
                         tmp_path, world=4)
    ref = _reference("lanegcn", unions)
    for r in ranks:
        got = r[key]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["loss"], rtol=LOSS_RTOL)
        for k, v in ref["counts"].items():
            if k.startswith("num_"):
                assert got["metrics"][k] == v, (k, got["metrics"][k], v)
        _close(got["after"] - got["before"], ref["update"], "2x2 SGD update")
        assert torch.equal(got["after"], ranks[0][key]["after"])
    _close(sum(r[key]["grad"] for r in ranks) / 4, ref["grad"], "2x2 gradient")


@pytest.mark.slow
def test_two_rank_step_matches_the_jax_windowed_step(tmp_path):
    """The port's 2-rank windowed step (D=1×G=2, gloo) against the JAX
    package's make_windowed_parallel_train_step on a 1×2 mesh of the
    virtual CPU devices (tests/conftest.py): the same JAX init carried
    across by the weight bridge, the same balanced sub-packs, one SGD step
    (lr 0.1). The loss within 1e-5, the counts equal, and every parameter's
    update within 1e-4 of the largest update of its leaf (both frameworks
    sum the same fp32 terms in other orders; a gradient scale off by G
    misses by 100 %)."""
    import jax
    import jax.numpy as jnp

    from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
    from lanegcn_tpu.config import PackConfig as JPackConfig, TrainConfig as JTrainConfig
    from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
    from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_synthetic
    from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN
    from lanegcn_tpu.parallel import make_mesh_2d
    from lanegcn_tpu.parallel import windowed_parallel as jwp
    from lanegcn_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from lanegcn_tpu_torch.utils.weights import export_state_dict

    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK),
                   train=JTrainConfig(opt="sgd", lr=(0.1,), lr_epochs=()))
    scens = [jax_make_synthetic(seed=300 + i, num_corridors=2, num_actors=8) for i in range(4)]
    sub_cfg = jwp.subdivide_pack_config(jcfg.pack, 2)
    subs = []
    for grp in jwp.balance_scenarios(scens, 2, max_per_group=2):
        b, st = jax_pack_batch([scens[i] for i in grp], sub_cfg, jcfg.model)
        assert st["packed_scenarios"] == 2
        assert not any(v for k, v in st.items() if k.startswith("dropped")), st
        subs.append(b)
    jnet = JLaneGCN(jcfg.model)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(7),
                                jax.tree.map(jnp.asarray, subs[0]))["params"]
    params_np = jax.tree.map(np.asarray, params)
    tx, lr_fn = jax_make_optimizer(jcfg.train)
    step = jwp.make_windowed_parallel_train_step(
        jcfg, tx, lr_fn, make_mesh_2d(jax.devices()[:2], data=1, graph=2))
    batch = jax.tree.map(lambda *x: jnp.asarray(np.stack(x)[None]), *subs)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 (the step donates its inputs)
    p_new, _, jm = step(copy(params), tx.init(copy(params)), batch, 0.0)

    mcfg = _config("lanegcn").model
    weights = {k: torch.tensor(v) for k, v in export_state_dict(params_np, mcfg).items()}
    key = ("jax", "lanegcn", 1, 2)
    ranks = _spawn_ranks({key: {"packs": [PackedBatch.from_numpy(b) for b in subs],
                                "weights": weights}}, tmp_path)
    before = export_state_dict(params_np, mcfg)
    after = export_state_dict(jax.tree.map(np.asarray, p_new), mcfg)
    for r in ranks:
        got = r[key]
        np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]), rtol=1e-5)
        for k in ("num_cls", "num_reg", "num_scen"):
            assert got["metrics"][k] == float(jm[k]), k
        off = 0
        for name, p in _bundle("lanegcn").net.named_parameters():
            n = p.numel()
            upd = (got["after"][off:off + n] - got["before"][off:off + n]).reshape(p.shape)
            want = after[name] - before[name]
            tol = 1e-4 * float(np.abs(want).max()) + 1e-9
            err = float(np.abs(upd.numpy() - want).max())
            assert err <= tol, f"{name}: update off by {err} > {tol}"
            off += n


def _children(pid: int) -> list:
    """The processes whose parent is `pid` (from /proc)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return sorted(out)


def _torchrun(args, cwd, preempt_after=None):
    """python -m torch.distributed.run --nproc-per-node 2 -m
    lanegcn_tpu_torch.cli ARGS; with preempt_after, SIGTERM to one worker
    (the last started) once that many step lines are out. Returns stdout;
    the launcher must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "lanegcn_tpu_torch.cli", *args], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)

    def stop():  # the launcher and its workers: they share its session
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    timer = threading.Timer(600, stop)
    timer.start()
    lines, sent = [], False
    try:
        for ln in proc.stdout:
            lines.append(ln)
            steps = sum(1 for x in lines if x.startswith("epoch "))
            if preempt_after is not None and not sent and steps == preempt_after:
                os.kill(_children(proc.pid)[-1], signal.SIGTERM)
                sent = True
        err = proc.stderr.read()
        rc = proc.wait()
    finally:
        timer.cancel()
        stop()
        proc.wait()
    assert rc == 0, err[-3000:]
    assert preempt_after is None or sent
    return "".join(lines)


@pytest.mark.slow
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_two_rank_cli_resumes_bitwise(tmp_path, mesh):
    """`train --mesh` on 2 CPU ranks under torch.distributed.run: rank 0
    alone writes the log and the checkpoints, every rank takes the same
    steps; a run whose one worker gets SIGTERM stops on every rank at the
    same step, rank 0 saves, and the run resumed from that checkpoint ends
    bitwise the uninterrupted run's."""
    from lanegcn_tpu_torch.train.checkpoint import load_checkpoint

    def train(save_dir, *extra):
        return ["train", "--device", "cpu", "--mesh", mesh, "--data", "synthetic:16:1:4",
                "--batch-size", "2", "--epochs", "1", "--workers", "2", "--save-freq", "1",
                "--display-every", "1", "--save-dir", save_dir, *extra]

    steps = 16 // 2 // int(mesh.split("x")[0])
    out1 = _torchrun(train("r1"), tmp_path)
    assert f"{steps} steps/epoch on cpu" in out1
    assert f"mesh: data={mesh[0]} x graph={mesh[2]}" in out1
    assert sum(1 for ln in out1.splitlines() if ln.startswith("epoch ")) == steps
    assert sorted(os.listdir(tmp_path / "r1")) == ["1.000.ckpt", "files", "log"]
    out2 = _torchrun(train("r2"), tmp_path, preempt_after=2)
    saved = [ln for ln in out2.splitlines() if ": saved " in ln]
    assert len(saved) == 1 and saved[0].endswith(", exiting"), out2
    cut = saved[0].split(": saved ")[1][:-len(", exiting")]
    cut_step = load_checkpoint(str(tmp_path / cut))["step"]
    assert 2 <= cut_step < steps
    out3 = _torchrun(train("r2", "--resume", cut), tmp_path)
    assert sum(1 for ln in out3.splitlines() if ln.startswith("epoch ")) == steps - cut_step
    a = load_checkpoint(str(tmp_path / "r1" / "1.000.ckpt"))
    b = load_checkpoint(str(tmp_path / "r2" / "1.000.ckpt"))
    assert a["step"] == b["step"] == steps
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    for k in ("flat", "mu", "nu", "count"):
        assert torch.equal(a["flat_adam"][k], b["flat_adam"][k]), k
