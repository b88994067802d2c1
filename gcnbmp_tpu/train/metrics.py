"""Evaluation metrics: accuracy / ROC-AUC / PRC-AUC / F1 / precision / recall.

Logits are collected on device over the full evaluation set and metrics
finalized host-side — matching the reference's BatchEvaluator design
(training/extensions/batch_evaluator.py:29-101: sigmoid over all logits,
then the metric).  The metrics are numpy transcriptions of
scikit-learn's definitions (tests/test_metrics_numpy.py checks them
against scikit-learn where it is installed).  Multi-label variants average the metric per class
column, skipping degenerate columns instead of raising — the
``raise_value_error=False`` behavior of the reference's multilabel
evaluators (training/multilabel_extensions/roc_auc_evaluator.py:119-128).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve: the Mann-Whitney statistic, ties
    counted one half (equal to the trapezoidal ROC area)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # average rank (1-based) of each run of tied scores
    starts = np.r_[0, np.flatnonzero(np.diff(sorted_scores)) + 1]
    ends = np.r_[starts[1:], scores.size]
    ranks = np.empty(scores.size, np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def prc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Trapezoidal area under the precision-recall curve, with one
    point per distinct score plus the (recall 0, precision 1) end point
    (scikit-learn's ``auc(*precision_recall_curve(...)[1::-1])``)."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores, labels = scores[order], labels[order]
    last = np.r_[np.flatnonzero(np.diff(scores)), scores.size - 1]
    tps = np.cumsum(labels)[last]
    fps = 1 + last - tps
    precision = np.r_[(tps / (tps + fps))[::-1], 1.0]
    recall = np.r_[(tps / tps[-1])[::-1], 0.0]
    # recall falls along the curve, so the signed trapezoid sum is negative
    return float(-np.sum(np.diff(recall) * (precision[1:] + precision[:-1]))
                 / 2.0)


def _prf(labels: np.ndarray, preds: np.ndarray):
    """(precision, recall, f1) of the positive class; 0 where a ratio
    has a zero denominator."""
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0
    return precision, recall, f1


def binary_metrics(
    logits: np.ndarray, labels: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """Metrics for binary DDI (labels in {0,1}, logits pre-sigmoid)."""
    logits = np.ravel(np.asarray(logits, dtype=np.float64))
    labels = np.ravel(np.asarray(labels)).astype(np.int64)
    probs = _sigmoid(logits)
    preds = (probs >= threshold).astype(np.int64)
    out: Dict[str, float] = {
        "accuracy": float((preds == labels).mean()) if labels.size else float("nan"),
    }
    if labels.size and 0 < labels.sum() < labels.size:
        out["roc_auc"] = roc_auc(labels, probs)
        out["prc_auc"] = prc_auc(labels, probs)
    else:
        out["roc_auc"] = float("nan")
        out["prc_auc"] = float("nan")
    precision, recall, f1 = _prf(labels, preds)
    out["f1"] = f1
    out["precision"] = precision
    out["recall"] = recall
    return out


def multilabel_metrics(
    logits: np.ndarray, labels: np.ndarray, threshold: float = 0.5,
    class_names=None,
) -> Dict[str, float]:
    """Per-class-mean metrics for multi-hot labels (B, C).

    With ``class_names`` (length C), also returns a ``"per_class"`` dict
    mapping each name to its own roc_auc/prc_auc/f1/support — the
    per-column breakdown behind the reference evaluators' class means
    (training/multilabel_extensions/roc_auc_evaluator.py:119-128).
    """
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels).astype(np.int64)
    probs = _sigmoid(logits)
    preds = (probs >= threshold).astype(np.int64)
    rocs, prcs, f1s, accs, precs, recs = [], [], [], [], [], []
    per_class: Dict[str, Dict[str, float]] = {}
    for c in range(labels.shape[1]):
        y = labels[:, c]
        acc = float((preds[:, c] == y).mean())
        precision, recall, f1 = _prf(y, preds[:, c])
        accs.append(acc)
        f1s.append(f1)
        precs.append(precision)
        recs.append(recall)
        roc = prc = float("nan")
        if 0 < y.sum() < y.size:
            roc = roc_auc(y, probs[:, c])
            prc = prc_auc(y, probs[:, c])
            rocs.append(roc)
            prcs.append(prc)
        if class_names is not None:
            per_class[str(class_names[c])] = {
                "roc_auc": roc, "prc_auc": prc, "f1": f1,
                "support": int(y.sum()),
            }
    out: Dict[str, float] = {
        "accuracy": float(np.mean(accs)) if accs else float("nan"),
        "roc_auc": float(np.mean(rocs)) if rocs else float("nan"),
        "prc_auc": float(np.mean(prcs)) if prcs else float("nan"),
        "f1": float(np.mean(f1s)) if f1s else float("nan"),
        "precision": float(np.mean(precs)) if precs else float("nan"),
        "recall": float(np.mean(recs)) if recs else float("nan"),
    }
    if class_names is not None:
        out["per_class"] = per_class
    return out


def compute_metrics(
    logits: np.ndarray, labels: np.ndarray, class_num: int = 1,
    class_names=None,
) -> Dict[str, float]:
    if class_num > 1:
        return multilabel_metrics(logits, labels, class_names=class_names)
    return binary_metrics(logits, labels)
