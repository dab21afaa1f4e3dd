"""The port's segment sum (ops/segment_sum.py) and the scatters and gathers
that run on it (ops/scatter.py), on CPU tensors (the plain versions),
against the JAX package: `sorted_segment_sum` / `scatter_add_sorted` in
interpret mode (as tests/test_pallas_kernels.py runs them), `scatter_add`,
and `masked_gather`'s VJP. Inputs come from numpy seeds.

Tolerances: float32 rtol 1e-6 (both sum the same fp32 values, the JAX kernel
through a one-hot matmul at HIGHEST precision, the port in edge order);
bfloat16 3e-2 of (rms + |ref|) per element (one flipped rounding of an
output is one bf16 ulp, 2^-8 relative). The LaneConv stack's scatters and
gathers make no `nonzero` call (no host sync), and a grouped window plan
that is not group-aligned raises in the stack instead of losing edges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.ops.pallas_scatter import scatter_add_sorted as jax_scatter_add_sorted
from lanegcn_tpu.ops.pallas_scatter import sorted_segment_sum as jax_sorted_segment_sum
from lanegcn_tpu.ops.scatter import masked_gather as jax_masked_gather
from lanegcn_tpu.ops.scatter import scatter_add as jax_scatter_add

from lanegcn_tpu_torch.config import ModelConfig, PackConfig, windowed_pack_config
from lanegcn_tpu_torch.data.packing import _pad_edges_sorted, pack_batch
from lanegcn_tpu_torch.data.synthetic import make_urban_scenario
from lanegcn_tpu_torch.graph import EdgeSet, PackedBatch
from lanegcn_tpu_torch.models.layers import init_parameters
from lanegcn_tpu_torch.models.map_net import LaneConvStack, graph_inputs
from lanegcn_tpu_torch.ops import scatter, segment_sum

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(port, ref, tag):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if tag == "float32":
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()))
    else:
        rms = float(np.sqrt(np.mean(ref ** 2)))
        assert np.all(np.abs(port - ref) <= 3e-2 * (rms + np.abs(ref))), float(
            np.abs(port - ref).max())


def _segments(seed, n=200, e=700, c=128):
    """Destination-sorted edges with empty rows (10..29 get none) and drops
    (seg = n and n + 5)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(10), np.arange(30, n)])
    seg = np.sort(np.concatenate([rng.choice(rows, e - 40), np.full(30, n), np.full(10, n + 5)]))
    data = rng.normal(size=(e, c)).astype(np.float32)
    out = rng.normal(size=(n, c)).astype(np.float32)
    return data, seg.astype(np.int32), out, n


@pytest.mark.parametrize("with_out", [False, True], ids=["sum", "into-out"])
@pytest.mark.parametrize("tag", ["float32", "bfloat16"])
def test_sorted_segment_sum_matches_jax(tag, with_out):
    data, seg, out, n = _segments(1)
    tdt, jdt = DTYPES[tag]
    jd = jnp.asarray(data, jdt)
    td = torch.from_numpy(data).to(tdt)
    if with_out:
        ref = jax_scatter_add_sorted(jd, jnp.asarray(seg), n, out=jnp.asarray(out, jdt),
                                     interpret=True)
        got = segment_sum.sorted_segment_sum(td, torch.from_numpy(seg).long(), n,
                                             torch.from_numpy(out).to(tdt))
    else:
        ref = jax_sorted_segment_sum(jd, jnp.asarray(seg), n, interpret=True)
        got = segment_sum.sorted_segment_sum(td, torch.from_numpy(seg).long(), n)
    assert got.dtype == tdt
    _close(got, ref, tag)
    assert not got[10:30].float().any() or with_out  # the empty rows stay empty


# The kernel's block partition (csrc/segment_sum.cu: 32 destination rows a
# block below 32,768 rows, 128 from there, each block's edges found by two
# searches, a run table per block): the same cases run against the kernel
# in chip_smoke.py's kernel_step.
BLOCK_CASES = {
    "run-longer-than-a-block": (700, lambda rng: np.sort(np.concatenate(
        [np.full(600, 5), rng.integers(0, 700, 301)]))),
    "runs-across-blocks": (1000, lambda rng: np.concatenate(
        [np.sort(rng.integers(250, 270, 502)), np.full(20, 1000)])),
    "all-dropped": (300, lambda rng: np.array([300] * 50 + [305] * 5)),
    "no-edges": (301, lambda rng: np.zeros(0, np.int64)),
    "rows-not-a-block-multiple": (777, lambda rng: np.sort(rng.integers(0, 790, 2003))),
    "128-row-blocks": (40003, lambda rng: np.sort(np.concatenate(
        [rng.integers(120, 140, 500), np.full(300, 20000), rng.integers(0, 40010, 2000)]))),
}


@pytest.mark.parametrize("with_out", [False, True], ids=["sum", "into-out"])
@pytest.mark.parametrize("tag", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_sorted_segment_sum_block_partition_matches_jax(case, tag, with_out):
    n, make = BLOCK_CASES[case]
    rng = np.random.default_rng(12)
    seg = make(rng).astype(np.int32)
    data = rng.normal(size=(len(seg), 128)).astype(np.float32)
    out = rng.normal(size=(n, 128)).astype(np.float32)
    tdt, jdt = DTYPES[tag]
    jd, td = jnp.asarray(data, jdt), torch.from_numpy(data).to(tdt)
    if with_out:
        ref = jax_scatter_add_sorted(jd, jnp.asarray(seg), n, out=jnp.asarray(out, jdt),
                                     interpret=True)
        got = segment_sum.sorted_segment_sum(td, torch.from_numpy(seg).long(), n,
                                             torch.from_numpy(out).to(tdt))
    else:
        ref = jax_sorted_segment_sum(jd, jnp.asarray(seg), n, interpret=True)
        got = segment_sum.sorted_segment_sum(td, torch.from_numpy(seg).long(), n)
    assert got.shape == (n, 128) and got.dtype == tdt
    _close(got, ref, tag)
    kept = seg[seg < n]
    empty = np.setdiff1d(np.arange(n), kept)
    base = out if with_out else np.zeros_like(out)
    # rows without edges are base's rows (or zeros), exactly
    np.testing.assert_array_equal(got[torch.from_numpy(empty)].float().numpy(),
                                  torch.from_numpy(base[empty]).to(tdt).float().numpy())


def test_scatter_add_sorted_vjp_matches_jax():
    data, seg, out, n = _segments(2, c=16)
    mask = np.random.default_rng(3).random(len(seg)) < 0.8
    g = np.random.default_rng(4).normal(size=(n, 16)).astype(np.float32)
    jm = jnp.asarray(mask)
    _, vjp = jax.vjp(lambda d, o: jax_scatter_add_sorted(d, jnp.asarray(seg), n, mask=jm, out=o,
                                                         interpret=True),
                     jnp.asarray(data), jnp.asarray(out))
    ref_d, ref_o = vjp(jnp.asarray(g))
    td = torch.from_numpy(data).requires_grad_(True)
    to = torch.from_numpy(out).requires_grad_(True)
    res = segment_sum.scatter_add_sorted(td, torch.from_numpy(seg), n, torch.from_numpy(mask), to)
    res.backward(torch.from_numpy(g))
    _close(td.grad, ref_d, "float32")
    _close(to.grad, ref_o, "float32")


@pytest.mark.parametrize("tag", ["float32", "bfloat16"])
def test_scatter_add_matches_jax(tag):
    """Random unsorted destinations (some out of range) and masks, into
    `out`; the float32 gradients against jax.vjp."""
    rng = np.random.default_rng(5)
    n, e, c = 150, 900, 32
    idx = rng.integers(0, n + 3, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    data = rng.normal(size=(e, c)).astype(np.float32)
    out = rng.normal(size=(n, c)).astype(np.float32)
    tdt, jdt = DTYPES[tag]
    ref = jax_scatter_add(jnp.asarray(data, jdt), jnp.asarray(idx), n, jnp.asarray(mask),
                          jnp.asarray(out, jdt))
    ti, tm = torch.from_numpy(idx).long(), torch.from_numpy(mask)
    td = torch.from_numpy(data).to(tdt).requires_grad_(True)
    to = torch.from_numpy(out).to(tdt).requires_grad_(True)
    got = scatter.scatter_add(td, ti, n, mask=tm, out=to)
    _close(got, ref, tag)
    if tag == "float32":
        g = rng.normal(size=(n, c)).astype(np.float32)
        _, vjp = jax.vjp(lambda d, o: jax_scatter_add(d, jnp.asarray(idx), n, jnp.asarray(mask), o),
                         jnp.asarray(data), jnp.asarray(out))
        ref_d, ref_o = vjp(jnp.asarray(g))
        got.backward(torch.from_numpy(g))
        _close(td.grad, ref_d, tag)
        _close(to.grad, ref_o, tag)


@pytest.mark.parametrize("order", ["sorted-in-backward", "order_by", "pack-inverse"])
def test_masked_gather_grad_matches_jax_vjp(order):
    """x[idx] with masked rows zeroed: the cotangent's segment sum into x's
    rows, in each kind of source order, against jax.vjp."""
    rng = np.random.default_rng(6)
    n, e, c = 120, 500, 24
    u = rng.integers(0, 60, 400)
    v = rng.integers(0, n, 400)
    es, _ = _pad_edges_sorted(u, v, e, n)  # destination-sorted, with the source inverse
    es = EdgeSet.from_numpy(es)
    x = rng.normal(size=(n, c)).astype(np.float32)
    g = rng.normal(size=(e, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_masked_gather(a, jnp.asarray(es.v.numpy()),
                                                 jnp.asarray(es.mask.numpy())), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    kinds = {"sorted-in-backward": None, "order_by": scatter.order_by(es.v, es.mask, n),
             "pack-inverse": scatter.src_order(es, n)}
    scatter.masked_gather(tx, es.v, es.mask, kinds[order]).backward(torch.from_numpy(g))
    _close(tx.grad, ref, "float32")
    if order != "sorted-in-backward":  # the same order as the sort made in the backward
        ty = torch.from_numpy(x).requires_grad_(True)
        scatter.masked_gather(ty, es.v, es.mask).backward(torch.from_numpy(g))
        assert torch.equal(tx.grad, ty.grad)


def test_table_order_is_the_sorted_order():
    """The stacked table gather's backward in the pack's table_inv order is
    bitwise the backward in one sort of the tables (contiguous pack)."""
    cfg = PackConfig(max_scenarios=2, max_actors=32, max_nodes=1536, max_edges_scale0=1664,
                     max_edges_dilated=2048, max_edges_lr=512, max_a2m_edges=2048,
                     max_m2a_edges=2048, max_a2a_edges=768)
    scens = [make_urban_scenario(seed=40 + i, num_corridors=3, num_actors=6) for i in range(2)]
    b, _ = pack_batch(scens, cfg, ModelConfig())
    graph = PackedBatch.from_numpy(b).graph
    names = [nm for nm in ("left", "right") if nm in graph.tables]
    assert names and graph.table_inv is not None
    n = graph.capacity
    stack = torch.stack([graph.tables[nm] for nm in names], 0)
    mask = stack < n
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(len(names), n, 8)).astype(
        np.float32))
    grads = []
    for order in (scatter.table_order(graph.table_inv, len(names), n),
                  scatter.order_by(stack, mask, n)):
        x = torch.from_numpy(np.random.default_rng(8).normal(size=(n, 8)).astype(np.float32))
        x.requires_grad_(True)
        scatter.masked_gather(x, stack, mask, order).backward(g)
        grads.append(x.grad)
    assert grads[0].abs().sum() > 0
    assert torch.equal(grads[0], grads[1])


# --- the LaneConv stack on a windowed pack ------------------------------------

MODEL = ModelConfig(n_actor=32, n_map=32, num_fuse_layers=2, num_att_layers=1)


@pytest.fixture(scope="module")
def windowed():
    scens = [make_urban_scenario(seed=90 + i, num_corridors=3, num_actors=6) for i in range(2)]
    b, st = pack_batch(scens, windowed_pack_config(2), MODEL)
    assert st["packed_scenarios"] == 2 and st["plan_edges"] > 0
    return PackedBatch.from_numpy(b).graph


def _stack(merge):
    stack = LaneConvStack(dataclasses.replace(MODEL, merge_plan_agg=merge), 2)
    init_parameters(stack, seed=0)
    return stack


@pytest.mark.parametrize("merge", ["off", "auto"])
def test_lane_conv_stack_makes_no_nonzero_call(windowed, merge):
    """Forward and backward of the stack (residue scatter, gathers, window
    plan, band layer) under torch.profiler: no aten::nonzero, the call that
    waits for the device on a card."""
    from torch.profiler import ProfilerActivity, profile

    stack = _stack(merge)
    feat = torch.randn(windowed.capacity, 32, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = stack(feat, **graph_inputs(windowed))
        out.square().mean().backward()
    names = [e.name for e in prof.events()]
    assert "aten::sort" in names  # the profile saw the stack's ops
    assert names.count("aten::nonzero") == 0
    assert torch.isfinite(out).all() and feat.grad.abs().sum() > 0


def test_unaligned_grouped_plan_raises_in_the_stack(windowed):
    """A dilated-relation edge moved into the left/right group's first chunk
    would be dropped by the plan kernels; the stack raises instead."""
    rel = windowed.plan_rel.clone()
    slot = int(torch.nonzero((windowed.plan_lu[:, 0] >= 0) & (rel[:, 0] >= 12))[0])
    rel[slot, 0] = 0  # pre0, a dilated relation, inside the left/right chunks
    stack = _stack("off")
    feat = torch.randn(windowed.capacity, 32)
    inputs = graph_inputs(windowed)
    stack(feat, **inputs)  # the packer's plan is aligned
    lu, lv, _, num_win = inputs["plan"]
    inputs["plan"] = (lu, lv, rel, num_win)
    with pytest.raises(RuntimeError, match="group-aligned"):
        stack(feat, **inputs)
