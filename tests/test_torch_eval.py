"""The port's eval report (lanegcn_tpu_torch/eval.py) against the JAX
package's lanegcn_tpu/eval.py on the same seeded arrays: the K=6 / K=1
metrics in both styles, the eval report, the metric sums and their
normalisation to 1e-12, the empty input, and the submission table."""

import sys

import numpy as np
import pytest

from lanegcn_tpu import eval as jeval
from lanegcn_tpu_torch import eval as teval


def _arrays(b=37, k=6, t=30, seed=3):
    rng = np.random.default_rng(seed)
    gts = rng.normal(0.0, 10.0, (b, t, 2)).astype(np.float32)
    # Some modes close to the truth, some far, so MR is neither 0 nor 1.
    preds = gts[:, None] + rng.normal(0.0, 2.0, (b, k, t, 2)).astype(np.float32)
    return preds, gts


def _close(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert abs(a[key] - b[key]) <= 1e-12, (key, a[key], b[key])


@pytest.mark.parametrize("k,log_style", [(6, False), (1, False), (6, True)])
def test_forecasting_metrics_match_jax(k, log_style):
    preds, gts = _arrays()
    _close(teval.forecasting_metrics(preds, gts, k=k, log_style=log_style),
           jeval.forecasting_metrics(preds, gts, k=k, log_style=log_style))


def test_report_and_sums_match_jax():
    preds, gts = _arrays()
    report = teval.evaluate_predictions(preds, gts)
    _close(report, jeval.evaluate_predictions(preds, gts))
    sums = teval.forecasting_metric_sums(preds, gts)
    _close(sums, jeval.forecasting_metric_sums(preds, gts))
    _close(teval.metrics_from_sums(sums), jeval.metrics_from_sums(sums))
    # The sums normalise to the report (summed over parts, as the CLI would).
    _close(teval.metrics_from_sums(sums), report)
    assert 0.0 < report["MR_6"] < 1.0


def test_empty_input_matches_jax():
    preds, gts = np.zeros((0, 6, 30, 2), np.float32), np.zeros((0, 30, 2), np.float32)
    sums = teval.forecasting_metric_sums(preds, gts)
    assert sums == jeval.forecasting_metric_sums(preds, gts)
    assert sums["count"] == 0.0
    assert teval.metrics_from_sums(sums) == jeval.metrics_from_sums(sums)


def test_npz_submission_table_matches_jax(tmp_path, monkeypatch):
    """The .npz branch (no h5py, as on the card's machine): the same
    argoverse_forecasting table of (seq_id, mode, x, y, probability) rows."""
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py → ImportError
    preds, _ = _arrays(b=5)
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    seq_ids = np.array([11, 4, 9, 100, 7])
    teval.write_submission(str(tmp_path / "port"), preds, seq_ids, probabilities=probs)
    jeval.write_submission(str(tmp_path / "jax"), preds, seq_ids, probabilities=probs)
    rows = np.load(tmp_path / "port.npz")["argoverse_forecasting"]
    assert rows.shape == (5 * 6 * 30, 5)
    np.testing.assert_array_equal(rows, np.load(tmp_path / "jax.npz")["argoverse_forecasting"])
    # Uniform probabilities by default.
    teval.write_submission(str(tmp_path / "uniform.npz"), preds, seq_ids)
    uni = np.load(tmp_path / "uniform.npz")["argoverse_forecasting"]
    np.testing.assert_array_equal(uni[:, 4], np.float32(1.0 / 6))
