"""LanePooling's two-Linear tail (`ops/row_tail.py`, K = 2): the bf16
backward kernel's schedule emulated on the CPU, and the work count the chip
bound is computed from.

The kernel (csrc/row_tail.cu `row_tail2_bwd`) cannot run here: its
schedule is emulated through the plain arithmetic instead. The chain pass's
warpgroups (two a block) walk 64-row tiles in turn and keep the six GN
vector sums across their tiles; a block's warpgroups are summed in order,
then the blocks in block order. The chain pass writes rnd(d_t1) and
rnd(d_t2) for the rows below N; the weight-gradient pass's splits each sum
h1ᵀ rnd(d_t1) and h2ᵀ rnd(d_t2) over 128-row tiles, h1 and h2 made again
from x with the tile's rows past N zero in x and in d_t, then the splits
are summed in split order.
"""

import numpy as np
import pytest
import torch

from lanegcn_tpu_torch.ops import row_tail
from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats

C = 128
EPS = 1e-5
# The bf16 backward's schedule (csrc/row_tail.cu RT_ROWS, RT_WGS, RB_DT).
CHAIN_TILE, CHAIN_WGS, DW_TILE = 64, 2, 128


def tail2_bwd_schedule(n: int, blocks: int):
    """The bf16 `row_tail2_bwd` kernel's tiles at n rows on `blocks` SMs:
    (chain, dw). chain[b][w]: the 64-row tiles warpgroup w of block b walks,
    in order; dw[s]: the 128-row tiles split s sums dW1 and dW2 over, in
    order."""
    tiles = -(-n // CHAIN_TILE)
    nb = min(blocks, -(-tiles // CHAIN_WGS))
    chain = [[list(range(b * CHAIN_WGS + w, tiles, nb * CHAIN_WGS)) for w in range(CHAIN_WGS)]
             for b in range(nb)]
    dw_tiles = -(-n // DW_TILE)
    splits = min(blocks, dw_tiles)
    return chain, [list(range(s, dw_tiles, splits)) for s in range(splits)]


def _inputs(n, seed=7):
    """x, res, W1, W2, the six GN vectors and a cotangent, from numpy."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(n, C), rng.randn(n, C), rng.randn(C, C) / np.sqrt(C),
              rng.randn(C, C) / np.sqrt(C)]
    for _ in range(3):
        arrays += [1 + 0.1 * rng.randn(C), 0.1 * rng.randn(C)]
    arrays.append(rng.randn(n, C))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _h(x, w1, g1w, g1b, g2w, g2b, rnd):
    """h1 = rnd(relu(GN1(x))) and h2 = rnd(relu(GN2(h1 @ W1))), as the
    weight-gradient pass makes them again from x."""
    nrm1, _ = gn_stats(x, EPS)
    h1 = rnd(torch.relu(nrm1 * g1w + g1b))
    nrm2, _ = gn_stats(h1 @ w1, EPS)
    return h1, rnd(torch.relu(nrm2 * g2w + g2b))


def _emulate_bwd(x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b, g, blocks):
    """`row_tail2_bwd_plain`'s arithmetic in the bf16 kernel's schedule
    (`tail2_bwd_schedule`): the same outputs in the same order."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    w1f, w2f = rnd(w1), rnd(w2)
    n = x.shape[0]
    # The chain pass, row by row.
    nrm1, inv1 = gn_stats(x.float(), EPS)
    h1_pre = nrm1 * g1w + g1b
    h1 = rnd(torch.relu(h1_pre))
    nrm2, inv2 = gn_stats(h1 @ w1f, EPS)
    h2_pre = nrm2 * g2w + g2b
    nrm3, inv3 = gn_stats(rnd(torch.relu(h2_pre)) @ w2f, EPS)
    d_y = torch.where(nrm3 * g3w + g3b + res.float() > 0, g.float(), 0.0)
    d_t2 = rnd(gn_bwd(d_y, nrm3, inv3, g3w))
    d_h2 = torch.where(h2_pre > 0, d_t2 @ w2f.t(), 0.0)
    d_t1 = rnd(gn_bwd(d_h2, nrm2, inv2, g2w))
    d_h1 = torch.where(h1_pre > 0, d_t1 @ w1f.t(), 0.0)
    d_x = gn_bwd(d_h1, nrm1, inv1, g1w)

    def rows(tile, size):
        return slice(tile * size, min(n, (tile + 1) * size))

    chain, dw = tail2_bwd_schedule(n, blocks)
    vecs = torch.zeros(6, C)
    for block in chain:  # block order
        part = torch.zeros(6, C)
        for tiles in block:  # the block's warpgroups, in warp order
            wg = torch.zeros(6, C)
            for t in tiles:
                r = rows(t, CHAIN_TILE)
                wg += torch.stack([(d_h1[r] * nrm1[r]).sum(0), d_h1[r].sum(0),
                                   (d_h2[r] * nrm2[r]).sum(0), d_h2[r].sum(0),
                                   (d_y[r] * nrm3[r]).sum(0), d_y[r].sum(0)])
            part += wg
        vecs += part
    # The weight-gradient pass: whole 128-row tiles, zero rows past n.
    mats = torch.zeros(2, C, C)
    for tiles in dw:  # split order
        part = torch.zeros(2, C, C)
        for t in tiles:
            r = rows(t, DW_TILE)
            pad = lambda a: torch.cat([a[r], a.new_zeros(DW_TILE - (r.stop - r.start), C)])
            th1, th2 = _h(pad(x.float()), w1f, g1w, g1b, g2w, g2b, rnd)
            part[0] += th1.t() @ pad(d_t1)
            part[1] += th2.t() @ pad(d_t2)
        mats += part
    return (d_x.to(dt), d_y.to(dt), mats[0], mats[1], *vecs.unbind(0))


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("n", [1, 65, 300])
def test_tail2_bwd_schedule_emulated_matches_plain(n, blocks):
    """The kernel's schedule through the plain arithmetic at fp32: every
    gradient within 1e-5 of `row_tail2_bwd_plain` (relative, scaled by the
    output's largest value: only the order of the sums differs, and the
    weight-gradient pass's padded rows add exact zeros), dx and dres equal
    (row-wise, no cross-row sum), and a rerun bitwise equal. One row, a
    chain tile and a row, and 300 rows (two weight-gradient tiles and a
    partial one), on 1, 3 and 132 blocks."""
    a = _inputs(n)
    want = row_tail.row_tail2_bwd_plain(*a)
    got = _emulate_bwd(*a, blocks)
    names = ("dx", "dres", "dW1", "dW2", "dg1w", "dg1b", "dg2w", "dg2b", "dg3w", "dg3b")
    for name, x, y in zip(names, got, want):
        assert x.shape == y.shape, name
        scale = float(y.abs().max())
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5 * scale, msg=name)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = _emulate_bwd(*a, blocks)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_tail2_bwd_schedule_covers_every_tile_once():
    """Each 64-row tile goes to one warpgroup and each 128-row tile to one
    split, at most `blocks` blocks and splits, no block without a tile."""
    for n in (1, 63, 64, 65, 127, 129, 300, 12345, 208896):
        for blocks in (1, 3, 132):
            chain, dw = tail2_bwd_schedule(n, blocks)
            seen = sorted(t for block in chain for tiles in block for t in tiles)
            assert seen == list(range(-(-n // 64)))
            assert len(chain) <= blocks and all(block[0] for block in chain)
            assert sorted(t for tiles in dw for t in tiles) == list(range(-(-n // 128)))
            assert len(dw) <= blocks and all(dw)


def test_tail2_work_bwd_hand_count():
    """`work2_bwd` at N = 65 in bf16, against a count by hand."""
    w = row_tail.work2_bwd(65, 2)
    # x, res, g read and dx, dres written (5 x 256 B a row); W1, W2 read in
    # bf16 and dW1, dW2 written in fp32; the six GN vectors read and their
    # gradients written (12 x 128 fp32).
    assert w["bytes"] == 65 * 5 * 256 + 2 * 128 * 128 * (2 + 4) + 12 * 128 * 4
    # Six [128 x 128] products a row: t1, t2, d_h2, d_h1, dW2, dW1.
    assert w["flops"] == 6 * 2 * 65 * 128 * 128
