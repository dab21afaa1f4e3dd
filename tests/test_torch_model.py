"""The port's LaneGCN against the JAX package's, module by module and as the
whole eval step, on one JAX-built windowed pack (grouped window plan, all
three fusion pair plans) with the JAX params carried across by the weight
bridge.

Small size: 32 channels, 2 LaneConv layers per stack, 2 Att per fusion
stage. Both sides run float32 on the CPU (the JAX side through its XLA
formulations, the port through its kernels' plain versions); they sum in
different orders, so outputs agree to ~1e-6 relative. The bound is 1e-4
relative to max(1, max |reference|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from lanegcn_tpu.config import PackConfig as JPackConfig
from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
from lanegcn_tpu.data.synthetic import make_urban_scenario as jax_make_urban
from lanegcn_tpu.models.actor_net import ActorNet as JActorNet
from lanegcn_tpu.models.fusion import Att as JAtt
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN
from lanegcn_tpu.models.map_net import MapNet as JMapNet
from lanegcn_tpu.models.pred_net import PredNet as JPredNet
from lanegcn_tpu.train.loop import make_eval_step as jax_make_eval_step

from lanegcn_tpu_torch.config import Config, ModelConfig, PackConfig, windowed_pack_config
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.train.loop import MetricAccumulator, make_eval_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=2)
PACK = dict(
    max_scenarios=3, max_actors=96, max_nodes=512 * 4, node_stride=512,
    max_plan_edges=1024, table_relations=(), actor_stride=32, fusion_pairs=True,
    pair_chunk=128, max_edges_scale0=512, max_edges_dilated=512, max_edges_lr=512,
    max_a2m_edges=6144, max_m2a_edges=6144, max_a2a_edges=1536)
REL = 1e-4


def _close(port, ref, rel=REL, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max()) if port.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.fixture(scope="module")
def world():
    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_urban(seed=50 + i, num_corridors=3, num_actors=8) for i in range(3)]
    batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
    assert stats["packed_scenarios"] == 3
    assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
    assert batch.graph.plan_lu is not None and batch.fusion.pair_a2a is not None
    jb = jax.tree.map(jnp.asarray, batch)
    jnet = JLaneGCN(jcfg.model)
    params = jnet.init(jax.random.PRNGKey(0), jb)["params"]
    params_np = jax.tree.map(np.asarray, params)
    cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACK))
    net = LaneGCN(cfg.model, device="cpu")
    load_jax_params(net, params_np, cfg.model)
    return dict(jcfg=jcfg, jnet=jnet, params=params, params_np=params_np, batch=batch,
                jb=jb, cfg=cfg, net=net, tb=PackedBatch.from_numpy(batch))


def test_state_dict_bridge_loads_strict(world):
    sd = export_state_dict(world["params_np"], world["cfg"].model)
    net = LaneGCN(world["cfg"].model, device="cpu", seed=5)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    # The stacked relation kernel [R, in, out] splits into per-relation
    # Linear weights [out, in] under the reference names.
    rel = world["params_np"]["map_net"]["fuse"]["rel_kernel_1"]
    np.testing.assert_array_equal(net.map_net.fuse["suc2"][1].weight.detach().numpy(),
                                  rel[8].T)
    np.testing.assert_array_equal(
        net.a2m.att[1].ctx[0].linear.weight.detach().numpy(),
        world["params_np"]["a2m"]["att1"]["ctx_hidden"]["linear"]["kernel"].T)


def test_actor_net_matches(world):
    feats = world["batch"].actors.feats
    ref = JActorNet(world["jcfg"].model).apply(
        {"params": world["params"]["actor_net"]}, jnp.asarray(feats))
    with torch.no_grad():
        out = world["net"].actor_net(torch.from_numpy(feats))
    _close(out, ref, what="actor_net")


def test_map_net_matches(world):
    ref = JMapNet(world["jcfg"].model).apply(
        {"params": world["params"]["map_net"]}, world["jb"].graph)
    with torch.no_grad():
        out = world["net"].map_net(world["tb"].graph)
    _close(out, ref, what="map_net")


@pytest.mark.parametrize("stage", ["a2m", "m2a", "a2a"])
def test_att_pair_branch_matches(world, stage):
    """One Att on its stage's window-pair plan, from seeded random rows."""
    rng = np.random.RandomState(7)
    b = world["batch"]
    c = MODEL["n_map"]
    nodes = rng.randn(b.graph.ctrs.shape[0], c).astype(np.float32)
    actors = rng.randn(b.actors.ctrs.shape[0], c).astype(np.float32)
    ac, nc = b.actors.ctrs, b.graph.ctrs
    if stage == "a2m":
        args = (nodes, nc, actors, ac, b.fusion.a2m, b.fusion.pair_a2m)
    elif stage == "m2a":
        args = (actors, ac, nodes, nc, b.fusion.m2a, b.fusion.pair_m2a)
    else:
        args = (actors, ac, actors, ac, b.fusion.a2a, b.fusion.pair_a2a)
    jargs = jax.tree.map(jnp.asarray, args)
    ref = JAtt(c, c).apply({"params": world["params"][stage]["att0"]}, *jargs)
    pair = PackedBatch.from_numpy(b).fusion
    pair = {"a2m": pair.pair_a2m, "m2a": pair.pair_m2a, "a2a": pair.pair_a2a}[stage]
    att = getattr(world["net"], stage).att[0]
    with torch.no_grad():
        out = att(torch.from_numpy(args[0]), torch.from_numpy(args[1]),
                  torch.from_numpy(args[2]), torch.from_numpy(args[3]), pair)
    _close(out, ref, what=f"{stage} att0")


@pytest.mark.parametrize("tie", [False, True], ids=["scores", "tied-scores"])
def test_pred_net_matches(world, tie):
    """PredNet incl. the mode order; with all scores tied the stable sort
    must keep the modes in order, as jnp.argsort does."""
    rng = np.random.RandomState(8)
    b = world["batch"]
    actors = rng.randn(b.actors.ctrs.shape[0], MODEL["n_actor"]).astype(np.float32)
    params = jax.tree.map(np.array, world["params_np"]["pred_net"])
    net = LaneGCN(world["cfg"].model, device="cpu")
    net.load_state_dict(world["net"].state_dict())
    if tie:
        params["cls_out"]["kernel"][:] = 0.0
        net.pred_net.cls[1].weight.data.zero_()
    cls_ref, reg_ref = JPredNet(world["jcfg"].model).apply(
        {"params": params}, jnp.asarray(actors), jnp.asarray(b.actors.ctrs))
    with torch.no_grad():
        cls, reg = net.pred_net(torch.from_numpy(actors), torch.from_numpy(b.actors.ctrs))
    _close(cls, cls_ref, what="cls")
    _close(reg, reg_ref, what="reg")
    if tie:
        unsorted = torch.stack([p(torch.from_numpy(actors)) for p in net.pred_net.pred], 1)
        ctrs = torch.from_numpy(b.actors.ctrs)[:, None, :]
        np.testing.assert_allclose(
            reg[:, :, -1].detach().numpy(),
            (unsorted.reshape(len(actors), 6, -1, 2)[:, :, -1] + ctrs).detach().numpy(),
            rtol=0, atol=1e-6)


def test_eval_step_matches(world):
    ref_out, ref_m = jax_make_eval_step(world["jcfg"], world["jnet"])(world["params"], world["jb"])
    out, m = make_eval_step(world["cfg"], world["net"], device="cpu")(world["batch"])
    _close(out["cls"], ref_out["cls"], what="cls")
    _close(out["reg"], ref_out["reg"], what="reg")
    assert set(m) == set(ref_m)
    for k in m:
        _close(m[k], ref_m[k], what=k)
    acc = MetricAccumulator()
    acc.update(m)
    s = acc.summary()
    assert all(np.isfinite(v) for v in s.values())
    assert s["ade"] > 0 and 0 <= s["mr"] <= 1


def test_windowed_pack_config_serves_at_full_width():
    """The geometry the port serves, as a user builds it: urban scenarios
    packed with `windowed_pack_config` drop nothing and carry the window
    plan and all three pair plans, and the full-width model's eval step
    runs on them (no NotImplementedError path) with finite outputs."""
    s = 2
    cfg = Config(pack=windowed_pack_config(s))
    scens = [make_urban_scenario(seed=i, num_corridors=7, num_actors=16) for i in range(s)]
    batch, stats = pack_batch(scens, cfg.pack, cfg.model)
    assert stats["packed_scenarios"] == s
    assert not any(v for k, v in stats.items() if k.startswith(("dropped", "skipped"))), stats
    assert batch.graph.plan_lu is not None and batch.graph.spill_pair is None
    assert all(p is not None for p in (batch.fusion.pair_a2m, batch.fusion.pair_m2a,
                                       batch.fusion.pair_a2a))
    net = LaneGCN(cfg.model, dtype=torch.float32, device="cpu", seed=0)
    out, m = make_eval_step(cfg, net, device="cpu")(batch)
    assert out["reg"].shape == (cfg.pack.max_actors, 6, 30, 2)
    assert torch.isfinite(out["reg"]).all() and torch.isfinite(out["cls"]).all()
    assert all(np.isfinite(float(v)) for v in m.values())
