"""The port's source-partitioned LaneConv stack and Att
(lanegcn_tpu_torch/parallel/graph_shard.py) at G = 2 against the JAX
package's make_sharded_lane_conv / make_sharded_att on two of the
conftest's virtual CPU devices, with the same weights (the weight bridge's
tables) and inputs, and the host partitioners against the JAX package's.

The weights are the port modules' seeded init, carried into JAX trees by
the bridge's tables. The port's side runs on two gloo ranks of one
torch.multiprocessing spawn (the module imports JAX only inside its
functions, so the spawned ranks do not); each returns its rows of the
stack's and the Att's outputs, fp32. Both sides compute the same fp32
terms, in other orders, so the outputs agree to the fp32 reorder error
(~1e-6 of their O(1) scale); checked at rtol = atol = 2e-4, the JAX
package's own tolerance for these functions (tests/test_graph_shard.py).
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lanegcn_tpu_torch.config import ModelConfig
from lanegcn_tpu_torch.graph import EdgeSet
from lanegcn_tpu_torch.models.fusion import Att
from lanegcn_tpu_torch.models.layers import init_parameters
from lanegcn_tpu_torch.models.map_net import LaneConvStack
from lanegcn_tpu_torch.parallel import graph_shard as gs
from lanegcn_tpu_torch.parallel.mesh import init_mesh
from lanegcn_tpu_torch.utils.weights import _att, _fuse_stack, _get_leaf, _to_torch

MODEL = dict(n_actor=32, n_map=32, num_fuse_layers=2)
PACK = dict(max_scenarios=4, max_actors=32, max_nodes=1024, max_edges_scale0=1024,
            max_edges_dilated=1024, max_edges_lr=512, max_a2m_edges=2048,
            max_m2a_edges=2048, max_a2a_edges=1024)
ATT_A, ATT_S, ATT_E = 64, 128, 256  # Att's destination and source rows, edge slots
TOL = 2e-4


def _jax_params(table, module):
    """The JAX params tree of a port module's seeded weights, by one of the
    weight bridge's tables (entries named "m.<torch name>"); checked to map
    back onto the same state dict."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    tree, rels = {}, {}
    for tkey, fpath, kind, rel in table:
        leaf = sd[tkey[2:]]
        leaf = leaf.T if kind == "linear" else leaf
        node = tree
        for key in fpath[:-1]:
            node = node.setdefault(key, {})
        if rel is None:
            node[fpath[-1]] = leaf
        else:
            rels.setdefault(fpath, {})[rel] = leaf
    for fpath, by_rel in rels.items():
        node = tree
        for key in fpath[:-1]:
            node = node[key]
        node[fpath[-1]] = np.stack([by_rel[r] for r in range(len(by_rel))])
    for tkey, fpath, kind, rel in table:
        leaf = np.asarray(_get_leaf(tree, fpath))
        back = _to_torch(leaf if rel is None else leaf[rel], kind)
        np.testing.assert_array_equal(back, sd[tkey[2:]], err_msg=tkey)
    return tree


def _pack():
    from lanegcn_tpu.config import Config as JConfig, ModelConfig as JModelConfig
    from lanegcn_tpu.config import PackConfig as JPackConfig
    from lanegcn_tpu.data.packing import pack_batch as jax_pack_batch
    from lanegcn_tpu.data.synthetic import make_synthetic_scenario as jax_make_scenario

    jcfg = JConfig(model=JModelConfig(**MODEL), pack=JPackConfig(**PACK))
    scens = [jax_make_scenario(seed=300 + i, num_corridors=2, num_actors=8) for i in range(4)]
    b, st = jax_pack_batch(scens, jcfg.pack, jcfg.model, split_bands=False,
                           split_tables=False, scenario_plan=False)
    assert st["packed_scenarios"] == 4
    assert not any(v for k, v in st.items() if k.startswith("dropped")), st
    return b, jcfg


def _rank_main(rank, port, path):
    torch.set_num_threads(1)
    w = torch.load(path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    mesh = init_mesh(1, 2, device="cpu")
    rows = lambda x: gs.local_rows(x, mesh)  # noqa: E731
    stack = LaneConvStack(ModelConfig(**MODEL), MODEL["num_fuse_layers"])
    stack.load_state_dict(w["stack"])
    att = Att(32, 32)
    att.load_state_dict(w["att"])
    mine = lambda es: {k: EdgeSet(u=e.u[rank], v=e.v[rank], mask=e.mask[rank])  # noqa: E731
                       for k, e in es.items()}
    with torch.no_grad():
        out = {"stack": gs.make_sharded_lane_conv(mesh, w["feat"].shape[0])(
            stack, rows(w["feat"]), mine(w["graph"])),
            "att": gs.make_sharded_att(mesh)(
                att, rows(w["agts"]), w["agt_ctrs"], rows(w["ctx"]), rows(w["ctx_ctrs"]),
                mine({"e": w["att_edges"]})["e"]),
            "counts": dict(mesh.counts)}
    torch.save(out, f"{path}.rank{rank}")
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from lanegcn_tpu.graph import EdgeSet as JEdgeSet
    from lanegcn_tpu.parallel import graph_shard as jgs

    b, jcfg = _pack()
    rng = np.random.default_rng(0)
    jmesh = JMesh(np.asarray(jax.devices()[:2]), ("graph",))
    n = b.graph.ctrs.shape[0]
    feat = rng.normal(size=(n, MODEL["n_map"])).astype(np.float32)
    stack = LaneConvStack(ModelConfig(**MODEL), MODEL["num_fuse_layers"])
    init_parameters(stack, 0)
    stack_table = _fuse_stack("m", (), jcfg.model.num_scales, MODEL["num_fuse_layers"])
    parts = jgs.partition_edges_by_source(b.graph.edges, n, 2)
    want_stack = jgs.make_sharded_lane_conv(jcfg.model, jmesh, n, MODEL["num_fuse_layers"])(
        _jax_params(stack_table, stack), jnp.asarray(feat), jax.tree.map(jnp.asarray, parts))

    agts = rng.normal(size=(ATT_A, 32)).astype(np.float32)
    agt_ctrs = rng.uniform(-10, 10, (ATT_A, 2)).astype(np.float32)
    ctx = rng.normal(size=(ATT_S, 32)).astype(np.float32)
    ctx_ctrs = rng.uniform(-10, 10, (ATT_S, 2)).astype(np.float32)
    mask = np.arange(ATT_E) < 200
    edges = JEdgeSet(u=rng.integers(0, ATT_A, ATT_E).astype(np.int32),
                     v=rng.integers(0, ATT_S, ATT_E).astype(np.int32), mask=mask)
    att = Att(32, 32)
    init_parameters(att, 1)
    att_parts = jgs.partition_edge_set_by_source(edges, ATT_S, 2)
    rows = [jnp.asarray(x) for x in (agts, agt_ctrs, ctx, ctx_ctrs)]
    want_att = jgs.make_sharded_att(jmesh, ATT_A)(_jax_params(_att("m", ()), att), *rows,
                                                  jax.tree.map(jnp.asarray, att_parts))

    tens = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    to_set = lambda e: EdgeSet(u=tens(e.u).long(), v=tens(e.v).long(),  # noqa: E731
                               mask=tens(e.mask))
    inputs = {
        "stack": stack.state_dict(), "att": att.state_dict(),
        "feat": tens(feat), "graph": {k: to_set(e) for k, e in parts.items()},
        "agts": tens(agts), "agt_ctrs": tens(agt_ctrs), "ctx": tens(ctx),
        "ctx_ctrs": tens(ctx_ctrs), "att_edges": to_set(att_parts),
    }
    path = str(tmp_path_factory.mktemp("graph_shard") / "inputs.pt")
    torch.save(inputs, path)
    mp.start_processes(_rank_main, args=(_free_port(), path), nprocs=2, join=True,
                       start_method="spawn")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(2)]
    return dict(ranks=ranks, stack=np.asarray(want_stack), att=np.asarray(want_att), pack=b)


@pytest.mark.parametrize("what", ["stack", "att"])
def test_sharded_layers_match_jax(world, what):
    got = torch.cat([r[what] for r in world["ranks"]]).numpy()
    np.testing.assert_allclose(got, world[what], rtol=TOL, atol=TOL)
    # A LaneConv layer: one reduce-scatter; an Att layer: one all_gather of
    # the queries and one reduce-scatter (no gradient, so no more).
    counts = world["ranks"][0]["counts"]
    assert counts["reduce_scatter"] == MODEL["num_fuse_layers"] + 1, counts
    assert counts["all_gather"] == 1, counts


@pytest.mark.parametrize("shards", [2, 4])
def test_partition_edges_by_source_matches_jax(world, shards):
    from lanegcn_tpu.parallel import graph_shard as jgs

    b = world["pack"]
    n = b.graph.ctrs.shape[0]
    got = gs.partition_edges_by_source(b.graph.edges, n, shards)
    want = jgs.partition_edges_by_source(b.graph.edges, n, shards)
    assert set(got) == set(want)
    for nm, e in want.items():
        for f in ("u", "v", "mask"):
            np.testing.assert_array_equal(getattr(got[nm], f), getattr(e, f), err_msg=nm)
    e = b.fusion.m2a
    got = gs.partition_edge_set_by_source(e, n, shards)
    want = jgs.partition_edge_set_by_source(e, n, shards)
    for f in ("u", "v", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
