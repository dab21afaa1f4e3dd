"""The port's LaneGCN on the two pack layouts besides the windowed one, against
the JAX package's LaneGCN on the same JAX-built pack, with one JAX init per
layout carried across by the weight bridge (a strict load):

- spill: the windowed layout with spill_pairs, a tiny window-plan budget
  and a small pair capacity, so the spill plan (`pair_aggregate`) and the
  classic residue lists both carry edges;
- contiguous: no windows, left/right neighbour tables (their rows
  gathered by `masked_gather`) and flat destination-sorted fusion lists
  (Att's edge-list branch: `masked_gather` and `fused_edge_mlp`).

Small size: 32 channels, 2 LaneConv layers per stack, 2 Att per fusion
stage. Both sides run float32 on the CPU (the JAX side through its XLA
formulations, the port through its kernels' plain versions). Outputs agree
within 1e-4 relative to max(1, max |reference|), as tests/test_torch_model.py;
each gradient leaf within 1e-4 of its largest reference element, as
tests/test_torch_train.py. Also: `bench_pack_config` and
`contiguous_pack_config` pack 32 urban scenarios with zero drops, and the
full-width model runs its eval step on each.
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
from lanegcn_tpu.models.fusion import Att as JAtt
from lanegcn_tpu.models.lanegcn import LaneGCN as JLaneGCN, pred_loss as jax_pred_loss

from lanegcn_tpu_torch.config import (Config, ModelConfig, PackConfig, bench_pack_config,
                                      contiguous_pack_config)
from lanegcn_tpu_torch.data.packing import pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import PackedBatch
from lanegcn_tpu_torch.models.lanegcn import LaneGCN
from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step
from lanegcn_tpu_torch.utils.weights import export_state_dict, load_jax_params

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=2)
PACKS = {
    "spill": dict(
        max_scenarios=3, max_actors=96, max_nodes=512 * 4, node_stride=512,
        max_plan_edges=64, table_relations=(), spill_pairs=True, max_spill_pair_edges=1024,
        pair_chunk=64, actor_stride=32, fusion_pairs=True, max_edges_scale0=512,
        max_edges_dilated=512, max_edges_lr=512, max_a2m_edges=6144, max_m2a_edges=6144,
        max_a2a_edges=1536),
    "contiguous": dict(
        max_scenarios=3, max_actors=48, max_nodes=1536, max_edges_scale0=768,
        max_edges_dilated=1024, max_edges_lr=256, max_a2m_edges=3072, max_m2a_edges=3072,
        max_a2a_edges=1152),
}
REL = 1e-4


@pytest.fixture(scope="module")
def worlds():
    """Each layout's world, built on first use (see `_world`)."""
    return {}


def _world(worlds, layout):
    """One JAX-built pack, one JAX init, the JAX forward, loss and gradients
    (one jit), and the port's net with the same weights; built once."""
    if layout not in worlds:
        jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACKS[layout]))
        scens = [jax_make_urban(seed=50 + i, num_corridors=3, num_actors=8) for i in range(3)]
        batch, stats = jax_pack_batch(scens, jcfg.pack, jcfg.model)
        assert stats["packed_scenarios"] == 3
        assert not any(v for k, v in stats.items() if k.startswith("dropped")), stats
        jb = jax.tree.map(jnp.asarray, batch)
        jnet = JLaneGCN(jcfg.model)
        params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jb)["params"]

        def objective(p):
            out = jnet.apply({"params": p}, jb)
            return jax_pred_loss(out, jb, jcfg.loss)["loss"], out

        (loss, out), grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
        params_np = jax.tree.map(np.asarray, params)
        cfg = Config(model=ModelConfig(**MODEL), pack=PackConfig(**PACKS[layout]))
        net = LaneGCN(cfg.model, device="cpu")
        load_jax_params(net, params_np, cfg.model)
        worlds[layout] = dict(
            batch=batch, params=params, params_np=params_np, cfg=cfg, net=net, loss=float(loss),
            out={k: np.asarray(v) for k, v in out.items()},
            grads=export_state_dict(jax.tree.map(np.asarray, grads), cfg.model))
    return worlds[layout]


def _close(port, ref, what, rel=REL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max()) if port.size else 0.0
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def test_packs_carry_their_layouts(worlds):
    """The spill pack routes edges through both the spill plan and the
    classic lists; the contiguous pack carries tables and sorted fusion
    lists and no plan of any kind."""
    g = _world(worlds, "spill")["batch"].graph
    assert g.spill_pair is not None and g.plan_lu is not None and not g.tables
    assert int((np.asarray(g.spill_pair.idx)[:, 0] >= 0).sum()) > 0
    assert sum(int(e.mask.sum()) for e in g.edges.values()) > 0
    b = _world(worlds, "contiguous")["batch"]
    assert set(b.graph.tables) == {"left", "right"} and b.graph.table_inv is not None
    assert b.graph.plan_lu is None and b.graph.spill_pair is None and b.fusion.pair_a2m is None
    assert PackedBatch.from_numpy(b).fusion.a2m.dst_sorted


@pytest.mark.parametrize("layout", ["spill", "contiguous"])
def test_eval_outputs_match(worlds, layout):
    w = _world(worlds, layout)
    out, m = make_eval_step(w["cfg"], w["net"], device="cpu")(w["batch"])
    _close(out["cls"], w["out"]["cls"], f"{layout} cls")
    _close(out["reg"], w["out"]["reg"], f"{layout} reg")
    _close(m["loss"], w["loss"], f"{layout} loss")
    assert all(np.isfinite(float(v)) for v in m.values())


@pytest.mark.parametrize("layout", ["spill", "contiguous"])
def test_grads_match_jax_grad(worlds, layout):
    """Every parameter's gradient of pred_loss, one train step on the CPU,
    against jax.grad, leaf by leaf (the strict state_dict names of both)."""
    w = _world(worlds, layout)
    net = LaneGCN(w["cfg"].model, device="cpu")
    net.load_state_dict(w["net"].state_dict(), strict=True)
    net, state = init_state(w["cfg"], net=net, device="cpu")
    metrics = make_train_step(w["cfg"], net, state, device="cpu")(w["batch"], 0.0)
    np.testing.assert_allclose(float(metrics["loss"]), w["loss"], rtol=1e-5)
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(w["grads"])
    for name, g in got.items():
        assert g is not None, f"{name}: no gradient"
        want = w["grads"][name]
        tol = 1e-4 * float(np.abs(want).max()) + 1e-9
        err = float(np.abs(g.numpy() - want).max())
        assert err <= tol, f"{layout} {name}: max abs err {err} > {tol}"


@pytest.mark.parametrize("stage", ["a2m", "m2a", "a2a"])
def test_att_edge_list_branch_matches(worlds, stage):
    """One Att on its stage's flat fusion list, from seeded random rows."""
    w = _world(worlds, "contiguous")
    rng = np.random.RandomState(9)
    b = w["batch"]
    c = MODEL["n_map"]
    nodes = rng.randn(b.graph.ctrs.shape[0], c).astype(np.float32)
    actors = rng.randn(b.actors.ctrs.shape[0], c).astype(np.float32)
    ac, nc = b.actors.ctrs, b.graph.ctrs
    args = {"a2m": (nodes, nc, actors, ac), "m2a": (actors, ac, nodes, nc),
            "a2a": (actors, ac, actors, ac)}[stage]
    edges = getattr(b.fusion, stage)
    ref = JAtt(c, c).apply({"params": w["params"][stage]["att0"]},
                           *map(jnp.asarray, args), jax.tree.map(jnp.asarray, edges))
    att = getattr(w["net"], stage).att[0]
    with torch.no_grad():
        out = att(*map(torch.from_numpy, args), None,
                  getattr(PackedBatch.from_numpy(b).fusion, stage))
    _close(out, ref, f"{stage} att0")


@pytest.mark.parametrize("make", [bench_pack_config, contiguous_pack_config],
                         ids=["bench", "contiguous"])
def test_pack_config_packs_urban_scenarios(make):
    """32 urban scenarios (the reference's batch) pack with zero drops: the
    bench geometry through both the spill plan and the classic lists, the
    contiguous one through tables and sorted fusion lists. Then the
    full-width model's eval step runs on a 2-scenario pack of the same
    geometry with finite outputs."""
    s = 32
    cfg = Config(pack=make(s))
    scens = [make_urban_scenario(seed=i, num_corridors=7, num_actors=16) for i in range(s)]
    batch, stats = pack_batch(scens, cfg.pack, cfg.model)
    assert stats["packed_scenarios"] == s
    assert not any(v for k, v in stats.items() if k.startswith(("dropped", "skipped"))), stats
    residue = sum(int(e.mask.sum()) for e in batch.graph.edges.values())
    if make is bench_pack_config:
        assert stats["spill_pair_edges"] > 0 and residue > 0, (stats["spill_pair_edges"], residue)
        assert batch.fusion.pair_a2m is not None and not batch.graph.tables
    else:
        assert set(batch.graph.tables) == {"left", "right"} and batch.graph.plan_lu is None
        assert batch.fusion.a2m.inv_perm is not None and batch.fusion.pair_a2m is None
    cfg2 = Config(pack=make(2))
    small, _ = pack_batch(scens[:2], cfg2.pack, cfg2.model)
    net = LaneGCN(cfg2.model, dtype=torch.float32, device="cpu", seed=0)
    out, m = make_eval_step(cfg2, net, device="cpu")(small)
    assert out["reg"].shape == (cfg2.pack.max_actors, 6, 30, 2)
    assert torch.isfinite(out["reg"]).all() and torch.isfinite(out["cls"]).all()
    assert all(np.isfinite(float(v)) for v in m.values())
