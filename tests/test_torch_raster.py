"""The port's raster path and the rest of the JAX surface, on the CPU against
the JAX package: RasterMapQuery and rasterize_lane_graph (exact),
get_pixel_feat / get_roi_feat, the 2-D blocks and EncodeDist through flax
with the weights carried across by utils/weights.py, segment_softmax, the
misc helpers and StepTimer.

Tolerances: integer and raster outputs exact; fp32 outputs within 1e-5
relative, with an absolute floor of 1e-5 of the output's RMS for the
blocks and linear_interp's weights (a ReLU or GroupNorm output, or a
weight, near zero carries the same absolute error as its neighbours) and
of 1e-30 for segment_softmax (exp underflow).
The port's feature maps are [C, H, W] and its 2-D blocks NCHW; the JAX
package's are [H, W, C] and NHWC, so the inputs are transposed on the way
in and the outputs on the way out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.data import raster as jax_raster
from lanegcn_tpu.models import layers as jax_layers
from lanegcn_tpu.ops import roi as jax_roi
from lanegcn_tpu.ops.scatter import segment_softmax as jax_segment_softmax
from lanegcn_tpu.utils import misc as jax_misc
from lanegcn_tpu.utils.profiling import StepTimer as JaxStepTimer

from lanegcn_tpu_torch.data import raster
from lanegcn_tpu_torch.models import layers
from lanegcn_tpu_torch.ops import roi
from lanegcn_tpu_torch.ops.scatter import segment_softmax
from lanegcn_tpu_torch.utils import misc
from lanegcn_tpu_torch.utils import profiling
from lanegcn_tpu_torch.utils.weights import load_block_params

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, floor=RTOL):
    """Elementwise within RTOL relative, with an absolute floor of `floor`
    times the RMS of `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rms = float(np.sqrt(np.mean(want ** 2))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor * rms)


def _rasters(scale):
    rng = np.random.RandomState(scale)
    m = (rng.rand(40 * scale, 60 * scale) > 0.5).astype(np.float32)
    return {"MIA": m}, {"MIA": np.array([10.0, 5.0])}


@pytest.mark.parametrize("autoclip", [True, False], ids=["autoclip", "noclip"])
@pytest.mark.parametrize("scale", [1, 2, 4, 8])
def test_query_matches(scale, autoclip):
    maps, offsets = _rasters(scale)
    port = raster.RasterMapQuery(scale, maps, offsets, autoclip=autoclip)
    ref = jax_raster.RasterMapQuery(scale, maps, offsets, autoclip=autoclip)
    for region in ([0, 20, 0, 10], [-20, 10, -10, 10], [30, 55, 20, 36]):
        for theta in (0, 90, 37, 360):
            got = port.query(region, theta=theta, city="MIA")
            want = ref.query(region, theta=theta, city="MIA")
            assert got.dtype == want.dtype and got.shape == want.shape, (region, theta)
            np.testing.assert_array_equal(got, want, err_msg=f"{region} {theta}")
    # 360 degrees is the identity; 90 degrees is np.rot90 of the unrotated crop.
    base = port.query([0, 20, 0, 20], theta=0, city="MIA")
    np.testing.assert_array_equal(port.query([0, 20, 0, 20], theta=360, city="MIA"), base)
    np.testing.assert_array_equal(raster._rotate_nearest(base, 90), np.rot90(base, 1))


@pytest.mark.parametrize("with_feats", [True, False], ids=["segments", "nodes"])
def test_rasterize_lane_graph_matches(with_feats):
    rng = np.random.RandomState(1)
    ctrs = rng.uniform(-30, 30, (50, 2))
    feats = rng.normal(0, 1.5, (50, 2)) if with_feats else None
    for scale in (1, 2, 4, 8):
        got = raster.rasterize_lane_graph(ctrs, feats, scale=scale)
        want = jax_raster.rasterize_lane_graph(ctrs, feats, scale=scale)
        assert got["map"].dtype == want["map"].dtype
        np.testing.assert_array_equal(got["map"], want["map"])
        np.testing.assert_array_equal(got["offset"], want["offset"])
    q = raster.RasterMapQuery.from_lane_graph(ctrs, feats, scale=2, autoclip=True)
    r = jax_raster.RasterMapQuery.from_lane_graph(ctrs, feats, scale=2, autoclip=True)
    np.testing.assert_array_equal(q.query([-30, 30, -20, 20], 37), r.query([-30, 30, -20, 20], 37))


def _feature_map(rng, h=40, w=60, c=5):
    """The same map as the port's [C, H, W] and the JAX package's [H, W, C]."""
    hwc = rng.rand(h, w, c).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(hwc.transpose(2, 0, 1))), jnp.asarray(hwc)


PTS_RANGE = (-30.0, 30.0, -20.0, 20.0)


def test_get_pixel_feat_matches():
    rng = np.random.RandomState(2)
    fm, fm_j = _feature_map(rng)
    pts = np.concatenate([rng.uniform(-35, 35, (300, 1)), rng.uniform(-25, 25, (300, 1))],
                         1).astype(np.float32)
    got = roi.get_pixel_feat(fm, torch.from_numpy(pts), PTS_RANGE)
    want = jax.jit(jax_roi.get_pixel_feat, static_argnums=2)(fm_j, jnp.asarray(pts), PTS_RANGE)
    assert got.shape == (300, 5)
    _close(got.numpy(), np.asarray(want), floor=0.0)
    interp = jax.jit(jax_roi.linear_interp, static_argnums=1)
    for n_max in (1, 7, 60):
        x = torch.from_numpy(rng.uniform(-0.2, 1.2, 100).astype(np.float32))
        lw, li, rw, ri = roi.linear_interp(x, n_max)
        jlw, jli, jrw, jri = interp(jnp.asarray(x.numpy()), n_max)
        np.testing.assert_array_equal(li.numpy(), np.asarray(jli))  # indices exact
        np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
        _close(lw.numpy(), jlw)  # XLA may fuse x * n_max - 0.5: an ulp apart
        _close(rw.numpy(), jrw)


@pytest.mark.parametrize("roi_size", [7, (4, 6)], ids=["square", "rect"])
def test_get_roi_feat_matches(roi_size):
    rng = np.random.RandomState(3)
    fm, fm_j = _feature_map(rng)
    n = 40
    boxes = np.stack([rng.uniform(-35, 35, n), rng.uniform(-25, 25, n), rng.uniform(2, 12, n),
                      rng.uniform(2, 12, n), rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    got = roi.get_roi_feat(fm, torch.from_numpy(boxes), roi_size, PTS_RANGE)
    want = np.asarray(jax.jit(jax_roi.get_roi_feat, static_argnums=(2, 3))(
        fm_j, jnp.asarray(boxes), roi_size, PTS_RANGE))
    rh, rw = (roi_size, roi_size) if isinstance(roi_size, int) else roi_size
    assert got.shape == (n, 5, rh, rw)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)  # the same bins out of range
    assert (want == 0).any() and (want != 0).any()
    _close(got, want, floor=0.0)


def _flax_block(module, x_nhwc, seed=0):
    """One jitted flax init (with its output): the params and the output."""
    out, params = jax.jit(module.init_with_output)(jax.random.PRNGKey(seed), jnp.asarray(x_nhwc))
    return params["params"], out


# case: (the JAX block under that name, the port's block), on BLOCK_X's 6
# channels.
BLOCKS = {
    "conv2d": (lambda n: jax_layers.Conv2dBlock(8, name=n), lambda: layers.Conv2dBlock(6, 8)),
    "conv2d_stride2": (lambda n: jax_layers.Conv2dBlock(8, stride=2, name=n),
                       lambda: layers.Conv2dBlock(6, 8, stride=2)),
    "postres": (lambda n: jax_layers.PostRes(6, name=n), lambda: layers.PostRes(6, 6)),
    "postres_down": (lambda n: jax_layers.PostRes(16, stride=2, name=n),
                     lambda: layers.PostRes(6, 16, stride=2)),
}
BLOCK_X = np.random.RandomState(4).randn(2, 12, 12, 6).astype(np.float32)


class _AllBlocks(jax_layers.nn.Module):
    """Every JAX block of BLOCKS side by side, so that one jitted init
    compiles them all."""

    @jax_layers.nn.compact
    def __call__(self, x):
        return {case: make(case)(x) for case, (make, _) in BLOCKS.items()}


@pytest.fixture(scope="module")
def flax_blocks():
    params, outs = _flax_block(_AllBlocks(), BLOCK_X)
    return {case: (params[case], np.asarray(outs[case])) for case in BLOCKS}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_2d_blocks_match_flax(case, flax_blocks):
    params, want = flax_blocks[case]
    port = BLOCKS[case][1]()
    if case.startswith("postres"):
        assert (port.downsample is not None) == (case == "postres_down")
    load_block_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(BLOCK_X).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("linear", [True, False], ids=["linear", "bare"])
def test_encode_dist_and_null_match_flax(linear):
    rng = np.random.RandomState(5)
    dist = (rng.randn(64, 2) * 20).astype(np.float32)
    params, want = _flax_block(jax_layers.EncodeDist(16, linear=linear), dist)
    want = np.asarray(want)
    port = layers.EncodeDist(16, linear=linear)
    load_block_params(port, params)
    with torch.no_grad():
        _close(port(torch.from_numpy(dist)).numpy(), want)
    null = jax_layers.Null()
    x = jnp.asarray(dist)
    np.testing.assert_array_equal(layers.Null()(torch.from_numpy(dist)).numpy(),
                                  np.asarray(null.apply(null.init(jax.random.PRNGKey(0), x), x)))


def test_segment_softmax_matches():
    ref = jax.jit(jax_segment_softmax, static_argnums=2)
    rng = np.random.RandomState(6)
    e, n = 400, 40
    idx = rng.randint(0, n - 10, e)  # segments n-10 .. n-1 stay empty
    mask = rng.rand(e) < 0.8
    logits = (rng.randn(e) * 3).astype(np.float32)
    logits[::7] = 1e4
    logits[3::11] = -1e4
    got = segment_softmax(torch.from_numpy(logits), torch.from_numpy(idx), n,
                          torch.from_numpy(mask)).numpy()
    want = np.asarray(ref(jnp.asarray(logits), jnp.asarray(idx), n, jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-30)
    assert (got[~mask] == 0).all()
    sums = np.bincount(idx[mask], got[mask], minlength=n)
    live = np.bincount(idx[mask], minlength=n) > 0
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)
    # Without a mask.
    got = segment_softmax(torch.from_numpy(logits), torch.from_numpy(idx), n).numpy()
    want = np.asarray(ref(jnp.asarray(logits), jnp.asarray(idx), n))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-30)


def test_misc_matches():
    rng = np.random.RandomState(7)
    data = {"a": rng.randn(10, 3), "b": np.arange(10)}
    idcs = np.array([7, 2, 2, 0])
    got, want = misc.index_dict(data, idcs), jax_misc.index_dict(data, idcs)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    xy, theta = rng.randn(20, 2), rng.uniform(-np.pi, np.pi, 20)
    np.testing.assert_array_equal(misc.rotate(xy, theta), jax_misc.rotate(xy, theta))
    dst_p, dst_j = {"x": 1, "y": 2}, {"x": 1, "y": 2}
    misc.merge_dict({"y": 3, "z": 4}, dst_p)
    jax_misc.merge_dict({"y": 3, "z": 4}, dst_j)
    assert dst_p == dst_j == {"x": 1, "y": 3, "z": 4}


def test_step_timer_matches(monkeypatch):
    clock = iter(np.cumsum([0.0, 0.1, 0.25, 0.05, 0.3, 0.2, 0.15, 0.4]).tolist() * 2)
    ticks = [(0, 0), (8, 100), (8, 120), (4, 40), (8, 90), (8, 100), (2, 5), (8, 130)]
    timers = []
    for cls in (profiling.StepTimer, JaxStepTimer):
        timer = cls(window=5)
        assert (timer.scen_per_s, timer.edges_per_s, timer.step_ms) == (0.0, 0.0, 0.0)
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        for s, e in ticks:
            timer.tick(s, e)
        timers.append((timer.scen_per_s, timer.edges_per_s, timer.step_ms, list(timer.times)))
    assert timers[0] == timers[1]
    assert len(timers[0][3]) == 5
