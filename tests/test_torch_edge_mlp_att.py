"""Att's flat-list edge MLP (`ops/edge_mlp.py`, Att's flags): the bf16
backward kernel's schedule emulated on the CPU, the all-padding list, and
the work counts the chip bounds are computed from.

The kernel (csrc/edge_mlp.cu `edge_mlp_bwd`) cannot run here: its schedule
is emulated through the plain arithmetic instead. The chain pass's
warpgroups walk 64-row tiles in turn and keep the vector sums (dbd, dgdow,
dgdob, dgchw, dgchb, the dWd rows) across their tiles; a block's
warpgroups are summed in order, then the blocks in block order. The
weight-gradient pass's splits each sum dWdo, dK1 and dWout over 64-edge
tiles, then the splits are summed in split order. The JAX parity of Att's
edge MLP is `tests/test_torch_pair_edge.py`'s.
"""

import numpy as np
import pytest
import torch

from lanegcn_tpu_torch.ops import edge_mlp
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats

C = 128
# The bf16 backward's schedule (csrc/edge_mlp.cu PT, PW_WGS; edge_tc.cuh
# DW_TE; ops/edge_mlp.py's splits): the chain pass's warpgroups (ATT_WGS a
# block) take ATT_TILE-row tiles in turn; the weight-gradient pass takes
# ATT_DW_TILE-edge tiles on at most half the blocks' splits.
ATT_TILE, ATT_WGS, ATT_DW_TILE = 64, 2, 64
NAMES = ("dd", "dqg", "dcg", "dWd", "dbd", "dWdo", "dgdow", "dgdob", "dK1", "dgchw", "dgchb",
         "dWout")


def att_bwd_schedule(e: int, blocks: int):
    """The bf16 `edge_mlp_bwd` kernel's tiles at e rows on `blocks` SMs:
    (chain, dw). chain[b][w]: the 64-row tiles warpgroup w of block b
    walks, in order (its vector sums, kept across them, are summed over the
    block's warps, then the blocks in block order); dw[s]: the 64-edge
    tiles split s sums dWdo, dK1 and dWout over, in order (the splits then
    summed in split order)."""
    tiles = -(-e // ATT_TILE)
    nb = min(blocks, -(-tiles // ATT_WGS))
    chain = [[list(range(b * ATT_WGS + w, tiles, nb * ATT_WGS)) for w in range(ATT_WGS)]
             for b in range(nb)]
    dw_tiles = -(-e // ATT_DW_TILE)
    splits = min(max(1, blocks // 2), dw_tiles)
    return chain, [list(range(s, dw_tiles, splits)) for s in range(splits)]


def _inputs(e, seed=37, pad=0):
    """Att's inputs from numpy: d [e, 2], qg, cg, the weights and a
    cotangent; the last `pad` rows are padding (d = qg = cg = 0) with a
    zero cotangent, as the model's scatter gives them."""
    rng = np.random.RandomState(seed)
    d = (3 * rng.randn(e, 2)).astype(np.float32)
    qg, cg, g = (rng.randn(e, C).astype(np.float32) for _ in range(3))
    if pad:
        d[e - pad:], qg[e - pad:], cg[e - pad:], g[e - pad:] = 0, 0, 0, 0
    mat = lambda: (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    vec = lambda s: (s * rng.randn(C)).astype(np.float32)
    arrays = [d, qg, cg, (rng.randn(2, C) / 2).astype(np.float32), vec(0.1), mat(),
              1 + vec(0.1), vec(0.1), mat(), 1 + vec(0.1), vec(0.1), mat(), g]
    return [torch.from_numpy(a) for a in arrays]


def _emulate_bwd(d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, g, blocks,
                 eps=1e-5):
    """`edge_mlp_bwd_plain`'s arithmetic in the bf16 kernel's schedule
    (`att_bwd_schedule`): the same outputs in the same order."""
    dt = cg.dtype
    rnd = lambda x: x.to(dt).float()
    w_d, w_do, w_1, w_out = (rnd(w) for w in (kd, kdo, k1, kout))
    dr = rnd(d)
    t1 = rnd(torch.relu(dr @ w_d + bd.float()))
    nrm_z, inv_z = gn_stats(t1 @ w_do, eps)
    t2 = rnd(torch.relu(nrm_z * gdow.float() + gdob.float()))
    nrm_s, inv_s = gn_stats(t2 @ w_1 + cg.float() + qg.float(), eps)
    e1 = rnd(torch.relu(nrm_s * gchw.float() + gchb.float()))
    d_e2 = rnd(g)
    d_gn_s = torch.where(e1 > 0, d_e2 @ w_out.t(), 0.0)
    d_s = rnd(gn_bwd(d_gn_s, nrm_s, inv_s, gchw))
    d_gn_z = torch.where(t2 > 0, d_s @ w_1.t(), 0.0)
    d_z = rnd(gn_bwd(d_gn_z, nrm_z, inv_z, gdow))
    d_t1p = torch.where(t1 > 0, d_z @ w_do.t(), 0.0)
    d1 = rnd(d_t1p)
    e = d.shape[0]

    def rows(tile, size):
        return slice(tile * size, min(e, (tile + 1) * size))

    chain, dw = att_bwd_schedule(e, blocks)
    vecs = torch.zeros(7, C)
    for block in chain:  # block order
        part = torch.zeros(7, C)
        for tiles in block:  # the block's warpgroups, in warp order
            wg = torch.zeros(7, C)
            for t in tiles:
                r = rows(t, ATT_TILE)
                wg += torch.stack([d_t1p[r].sum(0), (d_gn_z[r] * nrm_z[r]).sum(0),
                                   d_gn_z[r].sum(0), (d_gn_s[r] * nrm_s[r]).sum(0),
                                   d_gn_s[r].sum(0), *[(dr[r, k:k + 1] * d1[r]).sum(0)
                                                       for k in range(2)]])
            part += wg
        vecs += part
    mats = torch.zeros(3, C, C)
    for tiles in dw:  # split order
        part = torch.zeros(3, C, C)
        for t in tiles:
            r = rows(t, ATT_DW_TILE)
            part[0] += t1[r].t() @ d_z[r]
            part[1] += t2[r].t() @ d_s[r]
            part[2] += e1[r].t() @ d_e2[r]
        mats += part
    return (d1 @ w_d.t(), d_s.to(dt), d_s.to(dt), vecs[5:7], vecs[0], mats[0], vecs[1], vecs[2],
            mats[1], vecs[3], vecs[4], mats[2])


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("e,pad", [(1, 0), (63, 0), (65, 0), (700, 150)])
def test_att_bwd_schedule_emulated_matches_plain(e, pad, blocks):
    """The kernel's schedule through the plain arithmetic at fp32: every
    gradient within 1e-5 of `edge_mlp_bwd_plain` (relative, scaled by the
    output's largest value: only the order of the sums differs), dd, dqg
    and dcg equal (row-wise, no cross-row sum), and a rerun bitwise equal.
    One row, a tile less a row, a tile and a row, and 700 rows with 150
    padding rows, on 1, 3 and 132 blocks."""
    a = _inputs(e, pad=pad)
    want = edge_mlp.edge_mlp_bwd_plain(*a)
    got = _emulate_bwd(*a, blocks)
    for name, x, y in zip(NAMES, got, want):
        assert x.shape == y.shape, name
        scale = float(y.abs().max())
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5 * scale, msg=name)
    assert all(torch.equal(got[i], want[i]) for i in range(3))
    again = _emulate_bwd(*a, blocks)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_att_bwd_schedule_covers_every_tile_once():
    """Each 64-row tile goes to one warpgroup and each 64-edge tile to one
    split; at most `blocks` blocks and half as many splits (at least one),
    no block or split without a tile."""
    for e in (1, 63, 64, 65, 129, 700, 12345, 32768):
        for blocks in (1, 3, 132):
            chain, dw = att_bwd_schedule(e, blocks)
            seen = sorted(t for block in chain for tiles in block for t in tiles)
            assert seen == list(range(-(-e // 64)))
            assert len(chain) <= blocks and all(block[0] for block in chain)
            assert sorted(t for tiles in dw for t in tiles) == list(range(-(-e // 64)))
            assert len(dw) <= max(1, blocks // 2) and all(dw)


def test_att_all_padding():
    """All rows padding in Att's configuration (d = qg = cg = 0, zero
    cotangent): every output row equals row 0, and every backward output
    is exactly zero, in the plain version and in the kernel's schedule."""
    a = _inputs(65)
    for i in (0, 1, 2, 12):
        a[i] = torch.zeros_like(a[i])
    out = edge_mlp.edge_mlp_plain(*a[:12])
    assert torch.equal(out, out[:1].expand_as(out))
    assert all(not bool(x.any()) for x in edge_mlp.edge_mlp_bwd_plain(*a))
    assert all(not bool(x.any()) for x in _emulate_bwd(*a, 3))


def test_att_work_hand_count():
    """`work` and `work_bwd` with Att's flags at E = 65 in bf16 with 5
    padding rows, against counts by hand."""
    a = _inputs(65, pad=5)
    d = a[0]
    qg, cg, g = (a[i].to(torch.bfloat16) for i in (1, 2, 12))
    w = edge_mlp.work(d, qg, cg)
    # d (65 x 8 B), qg, cg and out (65 x 256 B each), Wd (2 x 128), Wdo, K1
    # and Wout (128 x 128 each) in bf16, bd and two GN pairs (5 x 128 fp32).
    assert w["bytes"] == 65 * (8 + 3 * 256) + (3 * 128 * 128 + 2 * 128) * 2 + 5 * 128 * 4
    # 60 live rows and one for the padding rows together, each d @ Wd and
    # three [128 x 128] products.
    assert w["live_rows"] == 61 and w["flops"] == 2 * 61 * (2 * 128 + 3 * 128 * 128)
    wb = edge_mlp.work_bwd(d, qg, cg, g)
    # d read and dd written (2 x 8 B), qg, cg, g read and dqg, dcg written
    # (5 x 256 B) per row; Wd, Wdo, K1 and Wout read in bf16 and their
    # gradients written in fp32; bd and the GN pairs read and their
    # gradients written (10 x 128 fp32).
    assert wb["bytes"] == (65 * (2 * 8 + 5 * 256) + (3 * 128 * 128 + 2 * 128) * (2 + 4)
                           + 10 * 128 * 4)
    # 60 rows with a cotangent: nine [128 x 128] products (three made
    # again, three transposed, three weight gradients) and three with Wd
    # (t1 made again, dWd, dd).
    assert wb["live_rows"] == 60 and wb["flops"] == 2 * 60 * (9 * 128 * 128 + 3 * 2 * 128)
