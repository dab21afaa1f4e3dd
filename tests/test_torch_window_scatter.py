"""The partition of the `window_scatter` kernels (csrc/window_scatter.cu),
emulated in PyTorch on the CPU and held bitwise to the plain versions
(which tests/test_torch_lanercnn.py holds to the JAX kernel).

Forward: the sorted key over the window-chunked edge slots (2·(w·stride +
lu) on an edge, 2·(w + 1)·stride − 1 on padding), segment_sum.cuh's blocks
of flat rows with their two 32-probe warp searches (`warp_lower_bound`),
the run table that passes over padding, and the sum from zero in edge order
with temp added last. Backward: the 64-slot tiles of one chunk, each
thread's 16-byte chunk of R rows. On chip_smoke.py's `SCATTER_CASES` and on
the three window-scatter cases of tests/test_torch_lanercnn.py, in float32
and bfloat16. Then the packer's precondition on a small real RoI pack: the
key is non-decreasing in both pooling directions.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke as cs
from lanegcn_tpu_torch.config import RoiPackConfig, ModelConfig
from lanegcn_tpu_torch.data.packing import window_chunked_edges
from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
from lanegcn_tpu_torch.data.synthetic import make_roi_scenario
from lanegcn_tpu_torch.ops.window_scatter import (WCHUNK, window_scatter_bwd_plain,
                                                  window_scatter_plain)

C, NT = 128, 256  # channels, threads a block (common.cuh)
BWD_TILE = 64     # the backward's slots a tile
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def win_keys(lu, wchunk, stride):
    """[E] int64: the forward's sorted key of each edge slot."""
    w = wchunk.long().repeat_interleave(WCHUNK)
    lu = lu.reshape(-1).long()
    return torch.where(lu >= 0, 2 * (w * stride + lu), 2 * (w + 1) * stride - 1)


def warp_lower_bound(keys, key):
    """segment_sum.cuh `warp_lower_bound`: 32 probes a step; the probes
    below key are the first c (keys sorted)."""
    lane = np.arange(32)
    lo, hi = 0, len(keys)

    def below(p, hi):
        return int(((p < hi) & (keys[np.minimum(p, max(hi - 1, 0))] < key)).sum()) if hi else 0

    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        c = below(lo + lane * step, hi)
        if c == 0:
            return lo
        b = lo + (c - 1) * step
        lo = b + 1
        if c < 32 and b + step < hi:
            hi = b + step
    return lo + below(lo + lane, hi)


def run_tables(keys, n):
    """Each flat row's run of slots [lo, hi) as the forward's blocks find
    them (128 rows a block from 32,768 rows on, else 32): two warp searches
    a block, then an entry starts (ends) a run where its key differs from
    its left (right) neighbour's; odd keys (padding) are passed over."""
    big = cs.SCATTER_BLOCKS
    rows_blk = big["ROWS_BIG"] if n >= big["BIG_FROM"] else big["ROWS_SMALL"]
    run_lo, run_hi = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for s0 in range(0, n, rows_blk):
        rows = min(rows_blk, n - s0)
        blo, bhi = warp_lower_bound(keys, 2 * s0), warp_lower_bound(keys, 2 * (s0 + rows))
        assert (blo, bhi) == tuple(np.searchsorted(keys, [2 * s0, 2 * (s0 + rows)]))
        e = np.arange(blo, bhi)
        k = keys[blo:bhi]
        live = k % 2 == 0
        left = np.concatenate([[True], k[1:] != k[:-1]]) if len(k) else k.astype(bool)
        right = np.concatenate([k[1:] != k[:-1], [True]]) if len(k) else k.astype(bool)
        r = k // 2 - s0
        assert ((r[live] >= 0) & (r[live] < rows)).all()
        lo_t, hi_t = np.zeros(rows_blk, np.int64), np.zeros(rows_blk, np.int64)
        lo_t[r[live & left]] = e[live & left] - blo
        hi_t[r[live & right]] = e[live & right] + 1 - blo
        run_lo[s0:s0 + rows], run_hi[s0:s0 + rows] = blo + lo_t[:rows], blo + hi_t[:rows]
    return run_lo, run_hi


def emulate_fwd(msg, temp, lu, wchunk, stride):
    """The forward kernel's output: rows without a run copy temp; a row's
    run is summed in fp32 from zero in edge order, then temp is added and
    the sum rounded once."""
    n = temp.shape[0]
    keys = win_keys(lu, wchunk, stride).numpy()
    assert (np.diff(keys) >= 0).all()
    lo, hi = run_tables(keys, n)
    ne = hi - lo
    # every live slot lies in exactly one run, the run of its own row
    live = np.flatnonzero(keys % 2 == 0)
    assert ne.sum() == len(live)
    owner = np.repeat(np.arange(n), ne)
    slots = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)] + [np.zeros(0, np.int64)])
    assert np.array_equal(np.sort(slots), live) and (keys[slots] == 2 * owner).all()
    acc = torch.zeros(n, C, dtype=torch.float32)
    lo_t, ne_t = torch.from_numpy(lo), torch.from_numpy(ne)
    for j in range(int(ne.max(initial=0))):
        sel = ne_t > j
        acc[sel] += msg[lo_t[sel] + j].float()
    out = temp.clone()
    sel = ne_t > 0
    out[sel] = (temp[sel].float() + acc[sel]).to(temp.dtype)
    return out


def emulate_bwd(g, lu, wchunk, stride):
    """The backward kernel's output: tile t's slots [64 t, 64 t + 64) lie in
    one chunk (wchunk read once); thread (c, r0) moves 16-byte chunk c of
    slots r0, r0 + RPP, ... of the tile, zeros on padding without reading g."""
    e_all = lu.shape[0]
    cpr = C * g.element_size() // 16  # chunks a row
    rpp = NT // cpr                   # rows a pass
    reps = BWD_TILE // rpp            # rows a thread a tile
    el = 16 // g.element_size()
    tiles = e_all // BWD_TILE
    t, k, tid = np.meshgrid(np.arange(tiles), np.arange(reps), np.arange(NT), indexing="ij")
    c, e = tid % cpr, t * BWD_TILE + tid // cpr + k * rpp
    assert (e // WCHUNK == (t * BWD_TILE) // WCHUNK).all()  # one chunk a tile
    # every (slot, chunk) moved exactly once
    assert (np.bincount((e * cpr + c).ravel(), minlength=e_all * cpr) == 1).all()
    w = wchunk.numpy()[(t * BWD_TILE) // WCHUNK].astype(np.int64)
    lv = lu.reshape(-1).numpy()[e].astype(np.int64)
    out = torch.full((e_all, C), float("nan"), dtype=g.dtype)
    gc = g.reshape(-1, cpr, el)
    oc = out.view(-1, cpr, el)
    pad = lv < 0
    oc[torch.from_numpy(e[pad]), torch.from_numpy(c[pad])] = 0
    src = torch.from_numpy((w * stride + lv)[~pad])
    oc[torch.from_numpy(e[~pad]), torch.from_numpy(c[~pad])] = gc[src, torch.from_numpy(c[~pad])]
    return out


def _ws_case(case, rng):
    """tests/test_torch_lanercnn.py's cases at 128 channels: random edges
    over 4 windows, the all-padding plan, a plan whose tail chunks repeat
    the last window id."""
    stride, nwin = 128, 4
    n_edges = {"random": 900, "all_padding": 0, "tail_chunks": 150}[case]
    u = rng.randint(0, (1 if case == "tail_chunks" else nwin) * stride, n_edges)
    es, dropped = window_chunked_edges(u, rng.randint(0, 50, n_edges), 4 * WCHUNK, stride, 50)
    assert dropped == 0
    t = torch.from_numpy
    return (t(rng.randn(4 * WCHUNK, C).astype(np.float32)),
            t(rng.randn(nwin * stride, C).astype(np.float32)),
            t(es.win_lu), t(es.win_chunk), stride)


_CASES = {}


def _case(name, backward):
    """(args) of a SCATTER_CASES or test_torch_lanercnn case, in bf16 rows."""
    if not _CASES:
        for bwd in (False, True):
            calls, _, _ = cs.scatter_case_calls(backward=bwd, dev="cpu")
            for (cname, *_), args in zip(cs.SCATTER_CASES, calls.values()):
                _CASES[cname, bwd] = args
        for cname in ("random", "all_padding", "tail_chunks"):
            msg, temp, lu, wc, stride = _ws_case(cname, np.random.RandomState(7))
            _CASES[cname, False] = [msg.bfloat16(), temp.bfloat16(), lu, wc, stride]
            _CASES[cname, True] = [temp.bfloat16(), lu, wc, stride]
    return _CASES[name, backward]


CASE_NAMES = [c[0] for c in cs.SCATTER_CASES] + ["random", "all_padding", "tail_chunks"]


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("case", CASE_NAMES)
def test_forward_partition_emulated_matches_the_plain_version(case, tag):
    a = cs.cast_args(_case(case, False), DTYPES[tag])
    got = emulate_fwd(*a)
    assert torch.equal(got, window_scatter_plain(*a))
    if not bool((a[2] >= 0).any()):
        assert torch.equal(got, a[1])


@pytest.mark.parametrize("tag", list(DTYPES))
@pytest.mark.parametrize("case", CASE_NAMES)
def test_backward_tiles_emulated_match_the_plain_version(case, tag):
    a = cs.cast_args(_case(case, True), DTYPES[tag])
    got = emulate_bwd(*a)
    assert torch.equal(got, window_scatter_bwd_plain(*a))
    if not bool((a[1] >= 0).any()):
        assert not bool(got.any())


@pytest.fixture(scope="module")
def roi_pack():
    """A small windowed RoI pack (3 scenarios, 256-row RoI and global windows)."""
    cfg = RoiPackConfig(max_scenarios=3, max_rois=36, max_interest_nodes=512,
                        max_edges_scale0=1024, max_edges_dilated=1024, max_edges_lr=1024,
                        max_a2m_edges=1024, max_pool_edges=16384, max_a2r_edges=2048,
                        max_roi_nodes=2048, node_stride=256, max_plan_edges=512,
                        max_global_nodes=1536, global_node_stride=256,
                        global_plan_edges=1024, table_relations=())
    scens = [make_roi_scenario(seed=s, num_corridors=2, num_actors=6) for s in (40, 41, 42)]
    pb, stats = pack_roi_batch(copy.deepcopy(scens), cfg, ModelConfig(n_actor=32, n_map=32))
    assert not any(v for k, v in stats.items() if "dropped" in k), stats
    return pb


@pytest.mark.parametrize("direction", ["r2g", "g2r"])
def test_packed_pool_edges_give_sorted_keys(roi_pack, direction):
    """The packer's window-chunked pool edges: the key is non-decreasing,
    and a valid edge's key is twice its destination row."""
    es = getattr(roi_pack, direction)
    keys = win_keys(torch.from_numpy(es.win_lu), torch.from_numpy(es.win_chunk),
                    es.win_stride).numpy()
    assert (np.diff(keys) >= 0).all()
    valid = es.win_lu.reshape(-1) >= 0
    assert valid.sum() > 100
    assert np.array_equal(keys[valid] // 2, es.u[valid]) and (keys[~valid] % 2 == 1).all()
