"""The port's Att at n_agt != n_ctx, and LaneGCN with n_map != n_actor,
against the JAX package on the CPU.

One JAX-built contiguous pack (tables and flat destination-sorted fusion
lists with the source inverse, the CLI's layout), one JAX init at n_map =
32, n_actor = 16 (A2M is Att(32, 16), M2A Att(16, 32): both directions in
one model) and one jit of the loss with its gradients, carried across by
the weight bridge. Both sides run float32 (the JAX side through its XLA
formulations, the port through its kernels' plain versions) and sum in
different orders:

- forwards within 1e-4 of max(1, max |reference|), as
  tests/test_torch_model.py;
- one Att layer's input and parameter gradients, and the plain kernel
  ops' VJPs at width 64 against the Pallas kernels in interpret mode,
  within 2e-5 of max(1, max |reference leaf|), as tests/test_torch_grads.py;
- the whole model's gradients within 1e-4 of each leaf's largest element,
  as tests/test_torch_layouts.py, plus 1e-6 of the model's largest
  gradient element (a leaf whose terms cancel keeps their reorder noise).

Also: the bridge round trip at unequal widths, att_sharded at G = 1 equal
to Att bitwise, a pack with fusion pair plans refused at unequal widths
(its A2M and M2A EdgeSets are empty shells), and the kernel wrappers'
width check.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig, TrainConfig as JTrainConfig
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.models.fusion import Att as JAtt
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss
from lanegcn_tpu.ops.pallas_edge_mlp import fused_edge_mlp as jax_edge_mlp
from lanegcn_tpu.ops.pallas_row_tail import fused_row_tail as jax_row_tail
from lanegcn_tpu.train.optimizer import make_optimizer as jax_make_optimizer

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.fusion import Att
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.ops import edge_mlp, row_tail
from lanegcn_tpu_torch.parallel import graph_shard
from lanegcn_tpu_torch.parallel.mesh import Mesh
from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step
from lanegcn_tpu_torch.utils.weights import (TABLES, _att, _get_leaf, export_state_dict,
                                              load_jax_params)

MODEL = dict(n_map=32, n_actor=16, num_fuse_layers=2, num_att_layers=2)
PACK = dict(max_scenarios=3, max_actors=48, max_nodes=1536, max_edges_scale0=768,
            max_edges_dilated=1024, max_edges_lr=256, max_a2m_edges=3072,
            max_m2a_edges=3072, max_a2a_edges=1152)
REL_FWD, REL_GRAD = 1e-4, 2e-5
W = 64  # the narrow width the kernels take


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the file's many small ops beside the other test
    processes (as tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The JAX pack, init, forward, loss and gradients (one jit), and the
    port's net with the same weights."""
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=50 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    assert batch.fusion.pair_a2m is None and int(batch.fusion.a2m.mask.sum()) > 0
    jb = jax.tree.map(jnp.asarray, batch)
    jnet = JLaneGCN(jcfg.model)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jb)["params"]

    def objective(p):
        out = jnet.apply({"params": p}, jb)
        return jax_pred_loss(out, jb, jcfg.loss)["loss"], out

    (loss, out), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    params_np = jax.tree.map(np.asarray, params)
    cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, params_np, cfg.model)
    return dict(batch=batch, params=params, params_np=params_np, cfg=cfg, net=net,
                loss=float(loss), out={k: np.asarray(v) for k, v in out.items()},
                grads=export_state_dict(jax.tree.map(np.asarray, grads), cfg.model))


def _close(port, ref, what, rel):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    err = float(np.abs(port - ref).max()) if port.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _stage_args(w, stage, seed):
    """(agts, agt_ctrs, ctx, ctx_ctrs) of one fusion stage, the rows from a
    numpy seed at each side's width, and its edge list."""
    rng = np.random.RandomState(seed)
    b = w["batch"]
    nodes = rng.randn(b.graph.ctrs.shape[0], MODEL["n_map"]).astype(np.float32)
    actors = rng.randn(b.actors.ctrs.shape[0], MODEL["n_actor"]).astype(np.float32)
    ac, nc = b.actors.ctrs, b.graph.ctrs
    args = {"a2m": (nodes, nc, actors, ac), "m2a": (actors, ac, nodes, nc)}[stage]
    return args, getattr(b.fusion, stage)


def test_weight_bridge_round_trips_at_unequal_widths(world):
    """The JAX params load strictly into the port's net (Att's ctx_hidden
    kernel [3·n_ctx, n_agt] as one SplitLinear weight) and come back out
    as the same state dict."""
    sd = export_state_dict(world["params_np"], world["cfg"].model)
    net = LaneGCN(world["cfg"].model, device="cpu", seed=5)
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    for stage, shape in (("a2m", (32, 48)), ("m2a", (16, 96)), ("a2a", (16, 48))):
        got = getattr(net, stage).att[1].ctx[0].linear.weight.detach().numpy()
        assert got.shape == shape, (stage, got.shape)
        np.testing.assert_array_equal(
            got, world["params_np"][stage]["att1"]["ctx_hidden"]["linear"]["kernel"].T)
    back = {k: v.numpy() for k, v in net.state_dict().items()}
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.mark.parametrize("stage", ["a2m", "m2a"])
def test_att_unequal_widths_match_jax(world, stage):
    """One Att at n_agt != n_ctx on its stage's flat list: its output, and
    its input and parameter gradients against jax.vjp."""
    args, edges = _stage_args(world, stage, seed=9)
    n_agt, n_ctx = args[0].shape[1], args[2].shape[1]
    params = world["params"][stage]["att0"]
    jatt = JAtt(n_agt, n_ctx)
    jedges = jax.tree.map(jnp.asarray, edges)

    def jfn(agts, ctx, p):
        return jatt.apply({"params": p}, agts, jnp.asarray(args[1]), ctx, jnp.asarray(args[3]),
                          jedges)

    ref, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(args[0]), jnp.asarray(args[2]), params)
    g = np.random.RandomState(10).randn(*ref.shape).astype(np.float32)
    d_agts, d_ctx, d_params = vjp(jnp.asarray(g))

    att = copy.deepcopy(getattr(world["net"], stage).att[0])
    agts, ctx = (torch.from_numpy(a).requires_grad_(True) for a in (args[0], args[2]))
    out = att(agts, torch.from_numpy(args[1]), ctx, torch.from_numpy(args[3]), None,
              getattr(PackedBatch.from_numpy(world["batch"]).fusion, stage))
    _close(out, ref, f"{stage} att0", REL_FWD)
    out.backward(torch.from_numpy(g))
    _close(agts.grad, d_agts, f"{stage} d_agts", REL_GRAD)
    _close(ctx.grad, d_ctx, f"{stage} d_ctx", REL_GRAD)
    named = dict(att.named_parameters())
    for tkey, fpath, kind, _ in _att("m", ()):
        want = np.asarray(_get_leaf(d_params, fpath))
        _close(named[tkey[2:]].grad, want.T if kind == "linear" else want,
               f"{stage} d{tkey[2:]}", REL_GRAD)


def test_lanegcn_forward_matches_jax(world):
    out, m = make_eval_step(world["cfg"], world["net"], device="cpu")(world["batch"])
    _close(out["cls"], world["out"]["cls"], "cls", REL_FWD)
    _close(out["reg"], world["out"]["reg"], "reg", REL_FWD)
    _close(m["loss"], world["loss"], "loss", REL_FWD)


def test_train_step_matches_jax(world):
    """One fp32 Adam train step: the loss and every gradient leaf against
    jax.grad, and the updated params against the JAX optimizer's
    fused_apply on the same gradients (Adam's first step moves a parameter
    by ~lr·sign(g), so the update is compared on one set of gradients; the
    gradients themselves are held to jax.grad above)."""
    net = LaneGCN(world["cfg"].model, device="cpu")
    net.load_state_dict(world["net"].state_dict(), strict=True)
    net, state = init_state(world["cfg"], net=net, device="cpu")
    metrics = make_train_step(world["cfg"], net, state, device="cpu")(world["batch"], 0.0)
    np.testing.assert_allclose(float(metrics["loss"]), world["loss"], rtol=1e-5)
    assert float(metrics["skipped"]) == 0.0
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(world["grads"])
    # A leaf whose terms cancel (a GroupNorm bias feeding a normalised sum)
    # keeps the fp32 reorder noise of its terms, not of its sum: the floor
    # is 1e-6 of the model's largest gradient element.
    floor = 1e-6 * max(float(np.abs(g).max()) for g in world["grads"].values())
    for name, g in got.items():
        assert g is not None, f"{name}: no gradient"
        want = world["grads"][name]
        tol = 1e-4 * float(np.abs(want).max()) + floor
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol, f"{name}: max abs err {err} > {tol}"

    # The port's gradients as a JAX params tree (the bridge's tables backwards).
    jgrads = jax.tree.map(np.zeros_like, world["params_np"])
    for tkey, fpath, kind, rel in TABLES["lanegcn"](world["cfg"].model):
        g = got[tkey].numpy()
        g = g.T if kind == "linear" else g.transpose(2, 1, 0) if kind == "conv1d" else g
        leaf = _get_leaf(jgrads, fpath)
        if rel is None:
            leaf[...] = g
        else:
            leaf[rel] = g
    jtx, jlr = jax_make_optimizer(JTrainConfig())
    params, _ = jtx.fused_apply(world["params"], jax.tree.map(jnp.asarray, jgrads),
                                jtx.init(world["params"]), jlr(0.0))
    ref = export_state_dict(jax.tree.map(np.asarray, params), world["cfg"].model)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=1e-6,
                                   err_msg=name)


def _leaves(arrays):
    return [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]


def _port_vjp(op, arrays, g):
    leaves = _leaves(arrays)
    out = op(*leaves)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction), out.grad_fn
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in leaves]


def test_row_tail_plain_at_width_64_matches_pallas():
    """The plain row_tail and row_tail_bwd at width 64 on 300 rows against
    the Pallas kernel in interpret mode: forward and jax.vjp."""
    rng = np.random.RandomState(31)
    n = 300
    gn = [a for _ in range(2) for a in ((1.0 + 0.1 * rng.randn(W)).astype(np.float32),
                                        (0.1 * rng.randn(W)).astype(np.float32))]
    arrays = [rng.randn(n, W).astype(np.float32), rng.randn(n, W).astype(np.float32),
              (rng.randn(W, W) / np.sqrt(W)).astype(np.float32), *gn]
    g = rng.randn(n, W).astype(np.float32)
    ref, vjp = jax.vjp(lambda *a: jax_row_tail(*a, mode="interpret"), *map(jnp.asarray, arrays))
    out, grads = _port_vjp(row_tail.fused_row_tail, arrays, g)
    _close(out, ref, "row_tail", REL_GRAD)
    for nm, got, want in zip(["x", "res", "w", "g1w", "g1b", "g2w", "g2b"], grads,
                             vjp(jnp.asarray(g))):
        _close(got, want, f"row_tail d{nm}", REL_GRAD)


def test_att_edge_mlp_plain_at_width_64_matches_pallas():
    """The plain edge_mlp and edge_mlp_bwd with Att's flags at width 64 on
    300 rows (the last 50 padding) against the Pallas kernel in interpret
    mode: forward and jax.vjp."""
    rng = np.random.RandomState(32)
    e, n_pad = 300, 50
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    d = (rng.randn(e, 2) * 3.0).astype(np.float32)
    qg, cg = r(e, W), r(e, W)
    g = rng.randn(e, W).astype(np.float32)
    for a in (d, qg, cg, g):
        a[e - n_pad:] = 0.0
    arrays = [d, qg, cg, r(2, W), r(W), r(W, W), r(W) + 1.0, r(W), r(W, W), r(W) + 1.0, r(W),
              r(W, W)]
    ref, vjp = jax.vjp(lambda *a: jax_edge_mlp(*a, True, True, 1e-5, True),
                       *map(jnp.asarray, arrays))
    out, grads = _port_vjp(edge_mlp.fused_edge_mlp, arrays, g)
    _close(out, ref, "edge_mlp", REL_GRAD)
    names = ["d", "qg", "cg", "kd", "bd", "kdo", "gdow", "gdob", "k1", "gchw", "gchb", "kout"]
    for nm, got, want in zip(names, grads, vjp(jnp.asarray(g))):
        _close(got, want, f"edge_mlp d{nm}", REL_GRAD)


@pytest.mark.parametrize("stage", ["a2m", "m2a"])
def test_att_sharded_one_shard_is_att(world, stage, monkeypatch):
    """att_sharded at G = 1 (the collectives are then the identity) is
    Att's unequal-width branch bitwise, forward and gradients."""
    monkeypatch.setattr(graph_shard, "gather_union", lambda x, mesh: x)
    monkeypatch.setattr(graph_shard, "reduce_scatter_rows", lambda x, mesh: x)
    mesh = Mesh(data=1, graph=1, rank=0, device=torch.device("cpu"), backend="gloo",
                graph_group=None, data_group=None, control_group=None)
    args, _ = _stage_args(world, stage, seed=11)
    edges = getattr(PackedBatch.from_numpy(world["batch"]).fusion, stage)
    outs, grads = [], []
    for sharded in (False, True):
        att = copy.deepcopy(getattr(world["net"], stage).att[1])
        agts, ctx = (torch.from_numpy(a).requires_grad_(True) for a in (args[0], args[2]))
        ac, cc = torch.from_numpy(args[1]), torch.from_numpy(args[3])
        if sharded:
            lists = graph_shard.fusion_lists(edges, agts.shape[0], ctx.shape[0])
            out = graph_shard.att_sharded(att, agts, ac, ctx, cc, lists, mesh)
        else:
            out = att(agts, ac, ctx, cc, None, edges)
        out.sum().backward()
        outs.append(out.detach())
        grads.append([agts.grad, ctx.grad] + [p.grad for p in att.parameters()])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_pair_plans_at_unequal_widths_raise():
    """A pack with fusion pair plans (its A2M and M2A EdgeSets are empty
    shells) is refused at n_map != n_actor, before any work."""
    cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(
        max_scenarios=2, max_actors=64, max_nodes=512 * 3, node_stride=512,
        max_plan_edges=1024, table_relations=(), actor_stride=32, fusion_pairs=True,
        pair_chunk=128, max_edges_scale0=512, max_edges_dilated=512, max_edges_lr=512,
        max_a2m_edges=4096, max_m2a_edges=4096, max_a2a_edges=1024))
    scens = [make_urban_scenario(seed=70 + i, num_corridors=3, num_actors=8) for i in range(2)]
    batch, stats = pack_batch(scens, cfg.pack, cfg.model)
    assert batch.fusion.pair_a2m is not None and not batch.fusion.a2m.mask.any()
    net = LaneGCN(cfg.model, device="cpu", seed=0)
    with pytest.raises(ValueError, match="flat lists"):
        make_eval_step(cfg, net, device="cpu")(batch)
    tb = PackedBatch.from_numpy(batch)
    att = Att(MODEL["n_actor"], MODEL["n_map"])
    with pytest.raises(ValueError, match="pair plans"):
        att(torch.zeros(tb.actors.ctrs.shape[0], MODEL["n_actor"]), tb.actors.ctrs,
            torch.zeros(tb.graph.ctrs.shape[0], MODEL["n_map"]), tb.graph.ctrs,
            tb.fusion.pair_m2a, tb.fusion.m2a)


@pytest.mark.parametrize("width", [64, 96, 128])
def test_kernel_width_checks(width):
    """row_tail's and Att's edge_mlp wrappers take rows 64 or 128 wide and
    name any other width (the check runs before a CUDA launch); so does the
    K = 2 tail's."""
    x, w, v = torch.zeros(4, width), torch.zeros(width, width), torch.zeros(width)
    d, kd = torch.zeros(4, 2), torch.zeros(2, width)
    for check in (lambda: row_tail._check(x, x, w, (v,) * 4),
                  lambda: edge_mlp._check(d, x, x, kd, (w,) * 3, (v,) * 5)):
        if width == 96:
            with pytest.raises(ValueError, match="96"):
                check()
        else:
            check()
    if width == 96:
        with pytest.raises(ValueError, match=str(width)):
            row_tail._check2(x, x, w, w, (v,) * 6)
    else:
        row_tail._check2(x, x, w, w, (v,) * 6)
