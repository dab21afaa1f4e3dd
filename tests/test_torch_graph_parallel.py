"""The port's explicit graph-parallel step (lanegcn_tpu_torch/parallel/
graph_parallel.py) on two gloo ranks on the CPU, against the single-device
step on the same flat pack in this process, and its host partitioners
against the JAX package's.

One torch.multiprocessing spawn of 2 ranks runs, for LaneGCN and LaneRCNN
at a few channels, one SGD step (lr 0.1, momentum trace) from one seeded
init at D=1×G=2: both ranks hold the whole flat pack and their own
column's edges. The loss, the support counts, the flat gradient (each
rank's local gradient, averaged over the ranks as the step's all_reduce
does) and the parameter update are checked against make_train_step on that
pack; both ranks must hold the same parameters. At D=2×G=1 with both
data rows on one pack, the step is bitwise make_train_step's (the layers
add in the one-card order). A NaN in rank 1's copy of the pack, in a row
that rank owns, makes every rank skip the update. Marked slow: 4 ranks at D=2×G=2, the JAX package's explicit steps,
and the CLI's `train --mesh 1x2 --graph-parallel explicit` under
torch.distributed.run with a bitwise resume.
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig, RoiPackConfig, TrainConfig
from lanegcn_tpu_torch.data.synthetic import make_roi_scenario, make_synthetic_scenario
from lanegcn_tpu_torch.graph import ShardedPack
from lanegcn_tpu_torch.models.registry import get_model
from lanegcn_tpu_torch.parallel import graph_parallel as gp
from lanegcn_tpu_torch.parallel.mesh import init_mesh
from lanegcn_tpu_torch.train.loop import init_state, make_train_step

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2)
# Capacities just over 4 scenarios' rows, so that every rank's row block
# holds live rows (flat packs fill from row 0).
PACK = dict(max_scenarios=4, max_actors=32, max_nodes=1024, max_edges_scale0=1024,
            max_edges_dilated=1024, max_edges_lr=1024, max_a2m_edges=2048, max_m2a_edges=2048,
            max_a2a_edges=1024)
ROI_PACK = dict(max_scenarios=4, max_rois=32, max_roi_nodes=1024, max_global_nodes=512,
                max_interest_nodes=512,
                max_edges_scale0=1024, max_edges_dilated=1024, max_edges_lr=1024,
                max_a2m_edges=1024, max_pool_edges=16384, max_a2r_edges=2048)
TRAIN = TrainConfig(opt="sgd", lr=(0.1,), lr_epochs=())
FAMILIES = ("lanegcn", "lanercnn")
# The loss within rtol 1e-4 (as tests/test_torch_mesh.py): both sides
# compute the same fp32 terms, the explicit step over row blocks with the
# relation products before the gather (other row counts in each product,
# other orders in the sums: ~1e-6).
LOSS_RTOL = 1e-4
# The flat gradient and the SGD update, elementwise within
# GRAD_TOL · (rms(reference) + |reference|), test_torch_mesh.py's rule: a
# gradient scale off by G, or a missed rank's rows, is off by ~100 %.
GRAD_TOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


def _config():
    return Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK),
                  roi_pack=RoiPackConfig(**ROI_PACK), train=TRAIN)


def _bundle(family):
    return get_model(family, _config(), device="cpu", seed=7)


def _scens(family, seed0, n=4):
    if family == "lanercnn":
        return [make_roi_scenario(seed=seed0 + i, num_corridors=1, num_actors=4)
                for i in range(n)]
    return [make_synthetic_scenario(seed=seed0 + i, num_corridors=2, num_actors=8)
            for i in range(n)]


def _sharded(family, scens, g):
    """Each of g columns' ShardedPack of one flat pack (zero drops)."""
    packs = []
    for col in range(g):
        sp, st = gp.explicit_packer(family, g, col)(scens, _config())
        bad = {k: v for k, v in st.items()
               if k.startswith(("dropped", "graph_dropped", "skipped")) and v}
        assert st["packed_scenarios"] == len(scens) and not bad, bad
        packs.append(ShardedPack.from_numpy(sp))
    pack = packs[0].pack
    spaces = ((pack.node_mask, pack.graph.node_mask) if family == "lanercnn"
              else (pack.graph.node_mask, pack.actors.mask))
    for live in spaces:  # the last rank's rows hold live rows too
        assert bool(live[-(live.shape[0] // g):].any())
    return packs


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
        net, state = init_state(bundle.config, net=bundle.net, device="cpu")
        step = gp.make_explicit_parallel_train_step(bundle.config, net, state, mesh, "cpu",
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
    rank], "weights": optional state dict}}, on `world` spawned gloo ranks."""
    path = str(tmp / "inputs.pt")
    torch.save(inputs, path)
    mp.start_processes(_rank_main, args=(_free_port(), path, world), nprocs=world, join=True,
                       start_method="spawn")
    return [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(world)]


def _reference(family, packs):
    """The single-device step from the same init on each pack: the mean
    loss, the other metrics summed, the mean flat gradient and the SGD
    update on that mean."""
    losses, grads, counts, afters = [], [], {}, []
    for b in packs:
        bundle = _bundle(family)
        net, state = init_state(bundle.config, net=bundle.net, device="cpu")
        m = make_train_step(bundle.config, net, state, "cpu", bundle.loss_fn,
                            bundle.metrics_fn)(b, 0.0)
        losses.append(float(m["loss"]))
        grads.append(_flat_grad(net))
        afters.append(state.opt.flat.clone())
        for k, v in m.items():
            if k not in ("loss", "lr", "skipped"):
                counts[k] = counts.get(k, 0.0) + float(v)
    grad = torch.stack(grads).mean(0)
    bundle = _bundle(family)
    net, state = init_state(bundle.config, net=bundle.net, device="cpu")
    before = state.opt.flat.clone()
    state.opt.step(state.lr_fn(0.0, "cpu"), reduce=lambda g: grad.clone())
    return dict(loss=float(np.mean(losses)), counts=counts, grad=grad,
                update=state.opt.flat - before, first_loss=losses[0], first_grad=grads[0],
                first_after=afters[0])


def _close(got, want, what):
    tol = GRAD_TOL * (want.square().mean().sqrt() + want.abs())
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"{what}: max err {float(err.max())}, " \
        f"worst over tolerance {float((err / tol).max())}"


def _check_step(ranks, key, ref):
    for r in ranks:
        got = r[key]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["loss"], rtol=LOSS_RTOL)
        for k, v in ref["counts"].items():
            if k.startswith("num_"):  # support counts: exact
                assert got["metrics"][k] == v, (k, got["metrics"][k], v)
            else:
                np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert got["metrics"]["skipped"] == 0.0
        _close(got["after"] - got["before"], ref["update"], f"{key} SGD update")
        assert torch.equal(got["after"], ranks[0][key]["after"])
    _close(sum(r[key]["grad"] for r in ranks) / len(ranks), ref["grad"], f"{key} gradient")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs, refs = {}, {}
    for family in FAMILIES:
        scens = _scens(family, 300)
        packs = _sharded(family, scens, 2)
        inputs[("step", family, 1, 2)] = {"packs": packs}
        refs[family] = _reference(family, [packs[0].pack])
        # G = 1 at D = 2, both rows on the same pack: the gradient's mean is
        # the one rank's gradient exactly.
        one = _sharded(family, scens, 1)[0]
        inputs[("one", family, 2, 1)] = {"packs": [one, one]}
    # A NaN in a row that rank 1 owns, in rank 1's copy of the pack alone.
    packs = list(inputs[("step", "lanegcn", 1, 2)]["packs"])
    pack = packs[1].pack
    feats = pack.actors.feats.clone()
    feats[feats.shape[0] // 2, 0, 0] = float("nan")
    packs[1] = dataclasses.replace(packs[1], pack=dataclasses.replace(
        pack, actors=dataclasses.replace(pack.actors, feats=feats)))
    inputs[("nan", "lanegcn", 1, 2)] = {"packs": packs}
    return _spawn_ranks(inputs, tmp_path_factory.mktemp("explicit")), refs


@pytest.mark.parametrize("family", FAMILIES)
def test_explicit_step_matches_the_single_device_step(run, family):
    ranks, refs = run
    key = ("step", family, 1, 2)
    _check_step(ranks, key, refs[family])
    # Collectives a step: LaneGCN's forward 2·2 LaneConv + 6 Att
    # reduce-scatters and 6 query + 1 output gathers, the backward the same
    # with the kinds swapped; LaneRCNN's 3·2 LaneConv + 2 pooling
    # reduce-scatters and 1 gather. Then the metrics' and the gradient's
    # all_reduce.
    counts = ranks[0][key]["counts"]
    each = 17 if family == "lanegcn" else 9
    assert counts["reduce_scatter"] == each and counts["all_gather"] == each, counts
    assert counts["all_reduce"] == 2, counts


@pytest.mark.parametrize("family", FAMILIES)
def test_one_shard_step_is_the_single_device_step_bitwise(run, family):
    """At G = 1 the explicit layers add in the one-card layers' order (the
    residual term as the partial's base, the products on the gathered
    rows): loss, gradient and parameters bitwise make_train_step's."""
    ranks, refs = run
    ref = refs[family]
    for r in ranks:
        got = r[("one", family, 2, 1)]
        assert got["metrics"]["loss"] == ref["first_loss"]
        assert torch.equal(got["grad"], ref["first_grad"])
        assert torch.equal(got["after"], ref["first_after"])


def test_nan_on_one_rank_skips_every_rank(run):
    ranks, _ = run
    for r in ranks:
        got = r[("nan", "lanegcn", 1, 2)]
        assert got["metrics"]["skipped"] == 1.0
        assert not np.isfinite(got["metrics"]["loss"])
        assert torch.equal(got["after"], got["before"])


# --- The host partitioners against the JAX package's, on one JAX pack. ---

def _jax_pack(flat_roi=False):
    """A JAX-built flat pack (numpy leaves) and its JAX config. (The JAX
    package is imported in the functions that use it: the spawned ranks
    import this module and need none of it.)"""
    from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
    from lanegcn_tpu.config import PackConfig as JPackConfig, RoiPackConfig as JRoiPackConfig
    from lanegcn_tpu.data.lane_roi import generate_lane_rois as jax_generate_lane_rois
    from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
    from lanegcn_tpu.data.packing_roi import pack_roi_batch as jax_pack_roi_batch
    from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_scenario

    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK),
                   roi_pack=JRoiPackConfig(**ROI_PACK))
    if flat_roi:
        scens = []
        for i in range(4):
            s = jax_make_scenario(seed=700 + i, num_corridors=1, num_actors=4)
            scens.append(jax_generate_lane_rois(s))
        b, st = jax_pack_roi_batch(scens, jcfg.roi_pack, jcfg.model, split_bands=False,
                                   split_tables=False)
    else:
        scens = [jax_make_scenario(seed=700 + i, num_corridors=2, num_actors=8)
                 for i in range(4)]
        b, st = jax_pack_batch(scens, jcfg.pack, jcfg.model, split_bands=False,
                               split_tables=False, scenario_plan=False)
    assert st["packed_scenarios"] == 4
    return b, jcfg


def _equal(got, want, what):
    for f in ("u", "v", "mask"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f"{what}.{f}")


@pytest.mark.parametrize("slack", [2.0, 0.5])
def test_partition_pack_edges_matches_jax(slack):
    """The lane relations and m2a equal JAX's partition_pack_edges at G = 2
    and 4; a2m and a2a equal JAX's _partition_one on the pack's actor rows
    (the JAX partition sizes them max_actors × max_scenarios, ROADMAP §3
    fault 7). At slack 0.5 shards overflow: the same edges are dropped and
    counted."""
    from lanegcn_tpu.graph import EdgeSet as JEdgeSet
    from lanegcn_tpu.parallel import graph_parallel as jgp

    b, jcfg = _jax_pack()
    n_nodes, n_act = b.graph.ctrs.shape[0], b.actors.ctrs.shape[0]
    lists = [(e, n_nodes) for e in b.graph.edges.values()] + [
        (b.fusion.m2a, n_nodes), (b.fusion.a2m, n_act), (b.fusion.a2a, n_act)]
    for g in (2, 4):
        got = gp.partition_pack_edges(b, _config(), g, slack)
        want = jgp.partition_pack_edges(b, jcfg, g, slack)
        for nm, e in want["graph"].items():
            _equal(got["graph"][nm], e, f"G={g} {nm}")
        _equal(got["m2a"], want["m2a"], f"G={g} m2a")
        dropped = 0
        for e, n_src in lists:
            cap = jgp.shard_edge_capacity(np.asarray(e.u).shape[-1], g, slack)
            su, sv, sm, d = jgp._partition_one(JEdgeSet(u=e.u, v=e.v, mask=e.mask), n_src, g,
                                               cap)
            dropped += d
            if n_src == n_act:
                k = "a2m" if e is b.fusion.a2m else "a2a"
                _equal(got[k], JEdgeSet(u=su, v=sv, mask=sm), f"G={g} {k}")
        assert got["dropped_edges"] == dropped
        assert (dropped > 0) == (slack < 1)


def test_partition_roi_pack_edges_matches_jax():
    from lanegcn_tpu.parallel import graph_parallel as jgp

    b, jcfg = _jax_pack(flat_roi=True)
    for g, slack in ((2, 2.0), (4, 2.0), (2, 0.5)):
        got = gp.partition_roi_pack_edges(b, _config(), g, slack)
        want = jgp.partition_roi_pack_edges(b, jcfg, g, slack)
        for fam in ("roi", "global"):
            assert set(got[fam]) == set(want[fam])
            for nm, e in want[fam].items():
                _equal(got[fam][nm], e, f"G={g} {fam} {nm}")
        for k in ("a2m", "r2g", "g2r"):
            _equal(got[k], want[k], f"G={g} {k}")
        assert got["dropped_edges"] == want["dropped_edges"]
        assert (got["dropped_edges"] > 0) == (slack < 1)


def test_shard_edge_capacity_matches_jax():
    from lanegcn_tpu.parallel import graph_parallel as jgp

    for cap in (1, 100, 128, 1000, 4096, 16384, 131072):
        for g in (1, 2, 3, 4, 8):
            for slack in (0.5, 1.0, 1.25, 2.0, 4.0):
                assert gp.shard_edge_capacity(cap, g, slack) == \
                    jgp.shard_edge_capacity(cap, g, slack), (cap, g, slack)


def test_capacity_check_names_what_does_not_divide():
    cfg = _config()
    gp.check_explicit_capacities(cfg, "lanegcn", 4)
    gp.check_explicit_capacities(cfg, "lanercnn", 4)
    with pytest.raises(ValueError, match="max_actors"):
        gp.check_explicit_capacities(
            dataclasses.replace(cfg, pack=dataclasses.replace(cfg.pack, max_actors=66)),
            "lanegcn", 4)
    with pytest.raises(ValueError, match="max_roi_nodes"):
        gp.check_explicit_capacities(
            dataclasses.replace(cfg, roi_pack=dataclasses.replace(cfg.roi_pack,
                                                                  max_roi_nodes=2050)),
            "lanercnn", 4)


# --- Slow: four ranks, the JAX explicit steps, the CLI. ---

@pytest.mark.slow
def test_four_rank_2x2_step_matches_the_mean_of_the_rows(tmp_path):
    """D=2×G=2 on 4 gloo ranks (LaneGCN): each data row one flat pack, its
    two columns' edges; the reference is the mean of the two rows'
    single-device steps."""
    rows = [_sharded("lanegcn", _scens("lanegcn", 500 + 10 * d), 2) for d in range(2)]
    key = ("step", "lanegcn", 2, 2)
    ranks = _spawn_ranks({key: {"packs": [p for row in rows for p in row]}}, tmp_path, world=4)
    _check_step(ranks, key, _reference("lanegcn", [row[0].pack for row in rows]))


@pytest.mark.slow
@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_the_jax_explicit_step(tmp_path, family):
    """The port's 2-rank explicit step (D=1×G=2, gloo) against the JAX
    package's make_explicit_parallel_train_step (LaneRCNN: the roi
    version) on a 1×2 mesh of the virtual CPU devices, the same JAX init
    carried across by the weight bridge, the same JAX-built flat pack, one
    SGD step (lr 0.1). The JAX LaneGCN step gets the port's partition (the
    JAX partition misplaces the actor-sourced edges at G > 1, ROADMAP §3
    fault 7). The loss within 1e-5, the counts equal, and every parameter's
    update within 1e-4 of the largest update of its leaf, plus two fp32
    roundings of its largest parameter."""
    import jax
    import jax.numpy as jnp

    from lanegcn_tpu.config import TrainConfig as JTrainConfig
    from lanegcn_tpu.graph import EdgeSet as JEdgeSet
    from lanegcn_tpu.models.registry import get_model as jax_get_model
    from lanegcn_tpu.parallel import graph_parallel as jgp
    from lanegcn_tpu.parallel import make_mesh_2d
    from lanegcn_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from lanegcn_tpu_torch.utils.weights import export_state_dict

    b, jcfg = _jax_pack(flat_roi=family == "lanercnn")
    jcfg = dataclasses.replace(jcfg, train=JTrainConfig(opt="sgd", lr=(0.1,), lr_epochs=()))
    jb = jax_get_model(family, jcfg)
    jcfg = jb.config
    jbatch = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), b)
    params = jax.jit(jb.net.init)(jax.random.PRNGKey(7), jbatch)["params"]
    params_np = jax.tree.map(np.asarray, params)
    tx, lr_fn = jax_make_optimizer(jcfg.train)
    if family == "lanercnn":
        parts = gp.partition_roi_pack_edges(b, _config(), 2)
        make = jgp.make_explicit_parallel_roi_train_step
    else:
        parts = gp.partition_pack_edges(b, _config(), 2)
        make = jgp.make_explicit_parallel_train_step
    parts.pop("dropped_edges")
    step = make(jcfg, tx, lr_fn, make_mesh_2d(jax.devices()[:2], data=1, graph=2),
                jb.loss_fn, jb.metrics_fn)
    def jax_edges(x):  # the port's partition as JAX EdgeSets [D=1, G, cap]
        if isinstance(x, dict):
            return {k: jax_edges(v) for k, v in x.items()}
        return JEdgeSet(*(jnp.asarray(np.asarray(getattr(x, f))[None])
                          for f in ("u", "v", "mask")))

    se = jax_edges(parts)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 (the step donates its inputs)
    p_new, _, jm = step(copy(params), tx.init(copy(params)),
                        jax.tree.map(lambda x: x[None], jbatch), se, 0.0)

    mcfg = _config().model
    weights = {k: torch.tensor(v) for k, v in export_state_dict(params_np, mcfg, family).items()}
    packs = [ShardedPack.from_numpy(ShardedPack(pack=b, edges=gp.column_edges(parts, g)))
             for g in range(2)]
    key = ("jax", family, 1, 2)
    ranks = _spawn_ranks({key: {"packs": packs, "weights": weights}}, tmp_path)
    before = export_state_dict(params_np, mcfg, family)
    after = export_state_dict(jax.tree.map(np.asarray, p_new), mcfg, family)
    for r in ranks:
        got = r[key]
        np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]), rtol=1e-5)
        for k in got["metrics"]:
            if k.startswith("num_"):
                assert got["metrics"][k] == float(jm[k]), k
        off = 0
        for name, p in _bundle(family).net.named_parameters():
            n = p.numel()
            upd = (got["after"][off:off + n] - got["before"][off:off + n]).reshape(p.shape)
            want = after[name] - before[name]
            # An update is read as after − before: one rounding of the
            # parameter (an ulp of 1.0 is 1.2e-7) beside its size.
            tol = 1e-4 * float(np.abs(want).max()) + 2 * EPS32 * float(np.abs(before[name]).max())
            err = float(np.abs(upd.numpy() - want).max())
            assert err <= tol, f"{name}: update off by {err} > {tol}"
            off += n


@pytest.mark.slow
def test_cli_explicit_mesh_resumes_bitwise(tmp_path):
    """`train --mesh 1x2 --graph-parallel explicit` on two CPU ranks: run A
    uninterrupted; run B preempted by a SIGTERM to one worker, then resumed
    from its checkpoint; B's last checkpoint equals A's bitwise, and the
    log names the explicit axis and counts no dropped shard edges."""
    from test_torch_mesh import _torchrun  # the launcher, its SIGTERM and exit checks

    from lanegcn_tpu_torch.train.checkpoint import load_checkpoint

    base = ["train", "--device", "cpu", "--mesh", "1x2", "--graph-parallel", "explicit",
            "--data", "synthetic:12:1:4", "--batch-size", "2", "--epochs", "2",
            "--save-freq", "1", "--display-every", "1"]
    a = _torchrun(base + ["--save-dir", str(tmp_path / "a")], tmp_path)
    assert "graph axis: explicit (source-partitioned)" in a, a
    assert "dropped" not in a, a
    assert "reduce_scatter" in a.splitlines()[-1], a
    b = _torchrun(base + ["--save-dir", str(tmp_path / "b")], tmp_path, preempt_after=3)
    # Rank 0 saves for the signalled rank: "<why>: saved PATH, exiting".
    saved = [ln for ln in b.splitlines() if ": saved " in ln and ln.endswith(", exiting")]
    assert len(saved) == 1, b
    cut = saved[0].split(": saved ", 1)[1][:-len(", exiting")]
    _torchrun(base + ["--save-dir", str(tmp_path / "b"), "--resume", cut], tmp_path)
    ca, cb = (load_checkpoint(str(tmp_path / r / "2.000.ckpt")) for r in ("a", "b"))
    assert ca["step"] == cb["step"]
    for k, v in ca["state_dict"].items():
        assert torch.equal(v, cb["state_dict"][k]), k
