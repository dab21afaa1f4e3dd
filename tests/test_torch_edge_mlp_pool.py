"""LanePooling's edge MLP (`ops/edge_mlp.py`, LanePooling's flags): the
bf16 backward kernel's schedule emulated on the CPU, and the work counts
the chip bounds are computed from.

The kernel (csrc/edge_mlp.cu `edge_mlp_pool_bwd`) cannot run here: its
schedule is emulated through the plain arithmetic instead. Pass 1's
warpgroups walk 64-row tiles in turn and keep the vector sums (dbd, dgchw,
dgchb, the dWd rows) across their tiles; a block's warpgroups are summed in
order, then the blocks in block order. Pass 2's splits each sum dK1 and
dWout over 128-edge tiles, then the splits are summed in split order.
"""

import numpy as np
import pytest
import torch

from lanegcn_tpu_torch.ops import edge_mlp
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats

C = 128
# The bf16 backward's schedule (csrc/edge_mlp.cu PT, PW_WGS, DT): the chain
# pass's warpgroups (POOL_WGS a block) take POOL_TILE-row tiles in turn;
# the weight-gradient pass takes POOL_DW_TILE-edge tiles.
POOL_TILE, POOL_WGS, POOL_DW_TILE = 64, 2, 128


def pool_bwd_schedule(e: int, blocks: int):
    """The bf16 `edge_mlp_pool_bwd` kernel's tiles at e rows on `blocks`
    SMs: (chain, dw). chain[b][w]: the 64-row tiles warpgroup w of block b
    walks, in order (its vector sums, kept across them, are summed over the
    block's warps, then the blocks in block order); dw[s]: the 128-edge
    tiles split s sums dK1 and dWout over, in order (the splits then summed
    in split order)."""
    tiles = -(-e // POOL_TILE)
    nb = min(blocks, -(-tiles // POOL_WGS))
    chain = [[list(range(b * POOL_WGS + w, tiles, nb * POOL_WGS)) for w in range(POOL_WGS)]
             for b in range(nb)]
    dw_tiles = -(-e // POOL_DW_TILE)
    splits = min(blocks, dw_tiles)
    return chain, [list(range(s, dw_tiles, splits)) for s in range(splits)]


def _inputs(e, seed=31, pad=0):
    """LanePooling's inputs from numpy: d [e, 4], cg, the weights and a
    cotangent; the last `pad` rows are padding (d = cg = 0) with a zero
    cotangent, as the model's scatter gives them."""
    rng = np.random.RandomState(seed)
    d = (3 * rng.randn(e, 4)).astype(np.float32)
    cg = rng.randn(e, C).astype(np.float32)
    g = rng.randn(e, C).astype(np.float32)
    if pad:
        d[e - pad:], cg[e - pad:], g[e - pad:] = 0, 0, 0
    arrays = [d, cg, (rng.randn(4, C) / 2).astype(np.float32),
              (0.1 * rng.randn(C)).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32),
              (1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
              (rng.randn(C, C) / np.sqrt(C)).astype(np.float32), g]
    return [torch.from_numpy(a) for a in arrays]


def _emulate_bwd(d, cg, kd, bd, k1, gchw, gchb, kout, g, blocks, eps=1e-5):
    """`edge_mlp_pool_bwd_plain`'s arithmetic in the bf16 kernel's schedule
    (`pool_bwd_schedule`): the same outputs in the same order."""
    dt = cg.dtype
    rnd = lambda x: x.to(dt).float()
    w_d, w_1, w_out = (rnd(w) for w in (kd, k1, kout))
    dr = rnd(d)
    t1 = rnd(torch.relu(dr @ w_d + bd.float()))
    nrm_s, inv_s = gn_stats(t1 @ w_1 + cg.float(), eps)
    e1 = rnd(torch.relu(nrm_s * gchw.float() + gchb.float()))
    d_e2 = rnd(g)
    d_gn = torch.where(e1 > 0, d_e2 @ w_out.t(), 0.0)
    d_s = rnd(gn_bwd(d_gn, nrm_s, inv_s, gchw))
    d_t1p = torch.where(t1 > 0, d_s @ w_1.t(), 0.0)
    d1 = rnd(d_t1p)
    e, din = d.shape

    def rows(tile, size):
        return slice(tile * size, min(e, (tile + 1) * size))

    chain, dw = pool_bwd_schedule(e, blocks)
    vecs = torch.zeros(3 + din, C)
    for block in chain:  # block order
        part = torch.zeros(3 + din, C)
        for tiles in block:  # the block's warpgroups, in warp order
            wg = torch.zeros(3 + din, C)
            for t in tiles:
                r = rows(t, POOL_TILE)
                wg += torch.stack([d_t1p[r].sum(0), (d_gn[r] * nrm_s[r]).sum(0), d_gn[r].sum(0),
                                   *[(dr[r, k:k + 1] * d1[r]).sum(0) for k in range(din)]])
            part += wg
        vecs += part
    mats = torch.zeros(2, C, C)
    for tiles in dw:  # split order
        part = torch.zeros(2, C, C)
        for t in tiles:
            r = rows(t, POOL_DW_TILE)
            part[0] += t1[r].t() @ d_s[r]
            part[1] += e1[r].t() @ d_e2[r]
        mats += part
    return (d1 @ w_d.t(), d_s.to(dt), vecs[3:], vecs[0], mats[0], vecs[1], vecs[2], mats[1])


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("e,pad", [(1, 0), (63, 0), (65, 0), (700, 100)])
def test_pool_bwd_schedule_emulated_matches_plain(e, pad, blocks):
    """The kernel's schedule through the plain arithmetic at fp32: every
    gradient within 1e-5 of `edge_mlp_pool_bwd_plain` (relative, scaled by
    the output's largest value: only the order of the sums differs), dd and
    dcg equal (row-wise, no cross-row sum), and a rerun bitwise equal. One
    row, a tile less a row, a tile and a row, and 700 rows with 100 padding
    rows, on 1, 3 and 132 blocks."""
    a = _inputs(e, pad=pad)
    want = edge_mlp.edge_mlp_pool_bwd_plain(*a)
    got = _emulate_bwd(*a, blocks)
    names = ("dd", "dcg", "dWd", "dbd", "dK1", "dgchw", "dgchb", "dWout")
    for name, x, y in zip(names, got, want):
        assert x.shape == y.shape, name
        scale = float(y.abs().max())
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5 * scale, msg=name)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = _emulate_bwd(*a, blocks)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_pool_bwd_schedule_covers_every_tile_once():
    """Each 64-row tile goes to one warpgroup and each 128-edge tile to one
    split, at most `blocks` blocks and splits, no block without a tile."""
    for e in (1, 63, 64, 65, 129, 700, 12345):
        for blocks in (1, 3, 132):
            chain, dw = pool_bwd_schedule(e, blocks)
            seen = sorted(t for block in chain for tiles in block for t in tiles)
            assert seen == list(range(-(-e // 64)))
            assert len(chain) <= blocks and all(block[0] for block in chain)
            assert sorted(t for tiles in dw for t in tiles) == list(range(-(-e // 128)))
            assert len(dw) <= blocks and all(dw)


def test_pool_plain_all_padding():
    """All rows padding (d = cg = 0, zero cotangent): every output row
    equals row 0, and every gradient is exactly zero."""
    a = _inputs(65)
    a[0], a[1], a[8] = torch.zeros(65, 4), torch.zeros(65, C), torch.zeros(65, C)
    out = edge_mlp.edge_mlp_plain(a[0], None, a[1], *a[2:4], None, None, None, *a[4:8],
                                  False, False)
    assert torch.equal(out, out[:1].expand_as(out))
    assert all(not bool(x.any()) for x in edge_mlp.edge_mlp_pool_bwd_plain(*a))


def test_pool_work_hand_count():
    """`work` with LanePooling's flags and `work_pool_bwd` at E = 65 in
    bf16 with 5 padding rows, against counts by hand."""
    a = _inputs(65, pad=5)
    d, cg, g = a[0], a[1].to(torch.bfloat16), a[8].to(torch.bfloat16)
    w = edge_mlp.work(d, None, cg, has_dist2=False)
    # d (65 x 16 B), cg and out (65 x 256 B each), Wd (4 x 128), K1 and Wout
    # (128 x 128 each) in bf16, bd and the GN pair (3 x 128 fp32).
    assert w["bytes"] == 65 * (16 + 2 * 256) + (2 * 128 * 128 + 4 * 128) * 2 + 3 * 128 * 4
    # 60 live rows and one for the padding rows together, each d @ Wd and
    # two [128 x 128] products.
    assert w["live_rows"] == 61 and w["flops"] == 2 * 61 * (4 * 128 + 2 * 128 * 128)
    wb = edge_mlp.work_pool_bwd(d, cg, g)
    # d read and dd written (2 x 16 B), cg, g read and dcg written (3 x
    # 256 B) per row; Wd, K1 and Wout read in bf16 and their gradients
    # written in fp32; bd, the GN pair read and their gradients written.
    assert wb["bytes"] == (65 * (2 * 16 + 3 * 256) + (2 * 128 * 128 + 4 * 128) * (2 + 4)
                           + 6 * 128 * 4)
    # 60 rows with a cotangent: five [128 x 128] products and three with Wd.
    assert wb["live_rows"] == 60 and wb["flops"] == 2 * 60 * (5 * 128 * 128 + 3 * 4 * 128)
