"""lane_layer at the row counts and masks the bf16 forward kernel's 192-row
blocks make edge cases of (csrc/lane_layer.cu lane_layer_tc_kernel): the
plain version and the public op (through its autograd Function) against
the Pallas kernel and its VJP in interpret mode, forward and gradients.
One JAX import for the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanegcn_tpu.ops.pallas_lane_layer import fused_lane_layer as jax_lane_layer

from lanegcn_tpu_torch.ops.lane_layer import fused_lane_layer, lane_layer_plain

C = 128
REL = 2e-5
SHIFTS = tuple(s for k in range(6) for s in (-(1 << k), 1 << k))
BLOCK = 192  # rows of one bf16 forward block


def _inputs(n, seed):
    """Random rows and weights; band masks with relation 3 all zero (no
    warpgroup runs it), and the ±32 relations set on the 40 rows around
    each block edge, so that their sources cross it."""
    rng = np.random.RandomState(seed)
    j = len(SHIFTS)
    feat = rng.randn(n, C).astype(np.float32)
    pre = rng.randn(n, C).astype(np.float32)
    masks = (rng.rand(j, n) < 0.5).astype(np.float32)
    masks[3] = 0.0
    for jj, s in enumerate(SHIFTS):
        if abs(s) == 32:
            for edge in range(BLOCK, n + BLOCK, BLOCK):
                masks[jj, max(edge - 20, 0):min(edge + 20, n)] = 1.0
    wb = (rng.randn(j, C, C) / np.sqrt(C)).astype(np.float32)
    w2 = (rng.randn(C, C) / np.sqrt(C)).astype(np.float32)
    gn = [(1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
          (1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)]
    g = rng.randn(n, C).astype(np.float32)
    return feat, pre, masks, wb, w2, gn, g


def _jax_reference(feat, pre, masks, wb, w2, gn, g):
    """The Pallas kernel takes a multiple of 128 rows: the rows are padded
    with zeros (which the port reads outside [0, N) too) and a zero
    cotangent (so that the padded rows feed no gradient), and cut back."""
    n = feat.shape[0]
    big = -(-n // 128) * 128
    pad = lambda a: np.pad(a, ((0, big - n), (0, 0)))
    jm = jnp.asarray(np.pad(masks, ((0, 0), (0, big - n))))
    args = tuple(map(jnp.asarray, (pad(feat), pad(pre), wb, w2, *gn)))
    out, vjp = jax.vjp(lambda f, p, b_, w, a, b, c, d: jax_lane_layer(
        f, p, jm, b_, w, a, b, c, d, SHIFTS, 1e-5, True), *args)
    grads = vjp(jnp.asarray(pad(g)))
    cut = lambda x, i: np.asarray(x)[:n] if i < 2 else np.asarray(x)
    return np.asarray(out)[:n], [cut(x, i) for i, x in enumerate(grads)]


def _close(port, ref, what):
    port = port.detach().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    tol = REL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("n", [191, 193, 385], ids=["block-less-1", "block-plus-1",
                                                     "two-blocks-plus-1"])
def test_lane_layer_ragged_rows_match_pallas(n):
    feat, pre, masks, wb, w2, gn, g = _inputs(n, seed=n)
    ref_out, ref = _jax_reference(feat, pre, masks, wb, w2, gn, g)
    t = lambda a: torch.from_numpy(a)
    m = t(masks) > 0
    _close(lane_layer_plain(t(feat), t(pre), m, t(wb), t(w2), *map(t, gn), SHIFTS), ref_out,
           f"n={n} plain out")
    leaves = [t(a).requires_grad_(True) for a in (feat, pre, wb, w2, *gn)]
    out = fused_lane_layer(leaves[0], leaves[1], m, *leaves[2:], SHIFTS)
    _close(out, ref_out, f"n={n} out")
    out.backward(t(g))
    for nm, leaf, want in zip(("dx", "dpre", "dwb", "dw2", "dg1w", "dg1b", "dg2w", "dg2b"),
                              leaves, ref):
        _close(leaf.grad, want, f"n={n} {nm}")
    # The all-zero relation gets no weight gradient.
    assert not leaves[2].grad[3].any()
