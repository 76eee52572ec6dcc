"""ROC / AUC evaluation (the JAX package's ``eval/roc.py``).

Ref: eval/ROC.java (binary, thresholded ROC curve + AUC) and
eval/ROCMultiClass.java (one-vs-all per class). The reference accumulates
TP/FP counts at ``thresholdSteps`` fixed thresholds; we do the same so
results are streaming-friendly and match its trapezoidal AUC.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ROC:
    """Binary ROC. ``probabilities``: P(class=1); labels: 0/1 (or one-hot
    with 2 columns, column 1 = positive, as in the reference)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.fp = np.zeros(threshold_steps + 1, dtype=np.int64)
        self.pos = 0
        self.neg = 0

    def eval(self, labels: np.ndarray, probabilities: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        probabilities = np.asarray(probabilities)
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            probabilities = probabilities.reshape(B * T, C)
            if mask is not None:
                keep = np.asarray(mask).reshape(B * T) > 0
                labels, probabilities = labels[keep], probabilities[keep]
        if labels.ndim == 2 and labels.shape[-1] == 2:
            y = labels[:, 1]
            p = probabilities[:, 1]
        else:
            y = labels.reshape(-1)
            p = probabilities.reshape(-1)
        y = (y > 0.5).astype(np.int64)
        self.pos += int(y.sum())
        self.neg += int((1 - y).sum())
        for i, t in enumerate(self.thresholds):
            pred = p >= t
            self.tp[i] += int((pred & (y == 1)).sum())
            self.fp[i] += int((pred & (y == 0)).sum())

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)] (ref: ROC.getResults())."""
        out = []
        for i, t in enumerate(self.thresholds):
            tpr = self.tp[i] / self.pos if self.pos else 0.0
            fpr = self.fp[i] / self.neg if self.neg else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def calculate_auc(self) -> float:
        """Trapezoidal AUC over the threshold-sampled curve
        (ref: ROC.calculateAUC())."""
        pts = sorted((fpr, tpr) for _, fpr, tpr in self.get_roc_curve())
        xs = np.array([p[0] for p in pts])
        ys = np.array([p[1] for p in pts])
        # numpy 2 names it trapezoid; numpy 1 trapz
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(ys, xs))


class ROCMultiClass:
    """One-vs-all ROC per class (ref: eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 100):
        self.steps = threshold_steps
        self.per_class: List[ROC] = []

    def eval(self, labels: np.ndarray, probabilities: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels)
        probabilities = np.asarray(probabilities)
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            probabilities = probabilities.reshape(B * T, C)
            if mask is not None:
                keep = np.asarray(mask).reshape(B * T) > 0
                labels, probabilities = labels[keep], probabilities[keep]
        n = labels.shape[-1]
        while len(self.per_class) < n:
            self.per_class.append(ROC(self.steps))
        for c in range(n):
            self.per_class[c].eval(labels[:, c], probabilities[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        if not self.per_class:
            return 0.0
        return float(np.mean([r.calculate_auc() for r in self.per_class]))
