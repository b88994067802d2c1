"""The numpy metrics against scikit-learn's definitions (skipped where
scikit-learn is not installed; the package itself does not need it)."""

import numpy as np
import pytest

from gcnbmp_tpu.train.metrics import (
    binary_metrics,
    multilabel_metrics,
    prc_auc,
    roc_auc,
)


def _scores(kind: str, n: int, rng):
    if kind == "continuous":
        return rng.normal(size=n)
    # heavy ties: 5 distinct values
    return rng.integers(0, 5, size=n).astype(np.float64)


@pytest.mark.parametrize("kind", ["continuous", "tied"])
@pytest.mark.parametrize("seed", [0, 1])
def test_roc_and_prc_match_sklearn(kind, seed):
    skm = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=301)
    s = _scores(kind, y.size, rng) + 0.7 * y
    assert roc_auc(y, s) == pytest.approx(skm.roc_auc_score(y, s), abs=1e-12)
    p, r, _ = skm.precision_recall_curve(y, s)
    assert prc_auc(y, s) == pytest.approx(skm.auc(r, p), abs=1e-12)


@pytest.mark.parametrize("positives", [0, 1, 17, 40])
def test_binary_metrics_match_sklearn(positives):
    skm = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(positives)
    y = np.zeros(40, np.int64)
    y[rng.permutation(40)[:positives]] = 1
    logits = rng.normal(size=40) + y
    got = binary_metrics(logits, y)
    preds = (1 / (1 + np.exp(-logits)) >= 0.5).astype(np.int64)
    assert got["f1"] == pytest.approx(skm.f1_score(y, preds, zero_division=0))
    assert got["precision"] == pytest.approx(
        skm.precision_score(y, preds, zero_division=0))
    assert got["recall"] == pytest.approx(
        skm.recall_score(y, preds, zero_division=0))
    if 0 < positives < 40:
        assert got["roc_auc"] == pytest.approx(skm.roc_auc_score(y, logits))
    else:
        assert np.isnan(got["roc_auc"]) and np.isnan(got["prc_auc"])


def test_multilabel_metrics_match_sklearn():
    skm = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, size=(64, 4))
    y[:, 3] = 0  # a degenerate column is skipped by the ranking means
    logits = rng.normal(size=(64, 4)) + y
    got = multilabel_metrics(logits, y, class_names=list("abcd"))
    rocs = [skm.roc_auc_score(y[:, c], logits[:, c]) for c in range(3)]
    assert got["roc_auc"] == pytest.approx(np.mean(rocs))
    assert np.isnan(got["per_class"]["d"]["roc_auc"])
