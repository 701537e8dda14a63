"""Area under the precision-recall curve, the anomaly workload's metric:
the port's own copy of `damc_tpu/metrics/prauc.py` (host NumPy, the same
numbers). sklearn's convention: distinct descending thresholds, the curve
closed at (recall 0, precision 1), the trapezoidal integral over recall.
It runs once an eval over a few thousand scores, on the host.
"""

from __future__ import annotations

import numpy as np


def auprc(scores, labels) -> float:
    """AUPRC of `scores` (N,), higher = predicted positive, against binary
    `labels` (N,), 1 = positive (anomalous); 0.0 without positives."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    order = np.argsort(-scores, kind="mergesort")
    s, y = scores[order], labels[order]

    # Evaluate at the last index of each distinct-threshold run.
    distinct = np.where(np.diff(s))[0]
    idxs = np.r_[distinct, s.size - 1]

    tp = np.cumsum(y)[idxs]
    fp = np.cumsum(1.0 - y)[idxs]
    precision = tp / np.maximum(tp + fp, 1e-300)
    if tp[-1] == 0:
        return 0.0
    recall = tp / tp[-1]

    precision = np.r_[1.0, precision]
    recall = np.r_[0.0, recall]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
    return float(trapezoid(precision, recall))
