"""Classification evaluation (the JAX package's ``eval/evaluation.py``,
kept as its own numpy copy): accuracy, top-N accuracy, per-class
precision, recall, F1, G-measure and Matthews correlation, and the
confusion matrix. Time series are flattened with the label mask's
excluded steps left out, as DL4J's evalTimeSeries does.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: np.ndarray, predicted: np.ndarray):
        np.add.at(self.matrix, (actual, predicted), 1)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])


class Evaluation:
    """Accumulating classification evaluator (ref: eval/Evaluation.java).

    ``top_n`` > 1 additionally tracks top-N accuracy (a prediction counts
    when the true class is among the N highest scores — ref:
    Evaluation.java topNCorrectCount/topNTotalCount).
    """

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None
        self.examples = 0
        self.top_n = max(1, int(top_n))
        self.top_n_correct = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        """labels/predictions: [B, C] one-hot/probabilities, or time series
        [B, T, C] (flattened with mask exclusion, as the reference's
        evalTimeSeries does)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            predictions = predictions.reshape(B * T, C)
            if mask is not None:
                keep = np.asarray(mask).reshape(B * T) > 0
                labels, predictions = labels[keep], predictions[keep]
        elif mask is not None:
            keep = np.asarray(mask).reshape(len(labels)) > 0
            labels, predictions = labels[keep], predictions[keep]
        self._ensure(labels.shape[-1])
        actual = np.argmax(labels, axis=-1)
        pred = np.argmax(predictions, axis=-1)
        self.confusion.add(actual, pred)
        self.examples += len(actual)
        if self.top_n > 1:
            k = min(self.top_n, predictions.shape[-1])
            topk = np.argpartition(predictions, -k, axis=-1)[:, -k:]
            self.top_n_correct += int((topk == actual[:, None]).any(axis=1).sum())

    @property
    def _matrix(self) -> np.ndarray:
        """Confusion matrix, or an all-zeros one before any eval() call —
        every metric then reads 0.0 instead of crashing."""
        if self.confusion is not None:
            return self.confusion.matrix
        return np.zeros((self.num_classes or 0, self.num_classes or 0),
                        dtype=np.int64)

    # ------------------------------------------------------------- counts
    def true_positives(self) -> Dict[int, int]:
        return {i: int(v) for i, v in enumerate(np.diag(self._matrix))}

    def false_positives(self) -> Dict[int, int]:
        m = self._matrix
        return {i: int(m[:, i].sum() - m[i, i]) for i in range(len(m))}

    def false_negatives(self) -> Dict[int, int]:
        m = self._matrix
        return {i: int(m[i, :].sum() - m[i, i]) for i in range(len(m))}

    def true_negatives(self) -> Dict[int, int]:
        m = self._matrix
        total = m.sum()
        return {i: int(total - m[i, :].sum() - m[:, i].sum() + m[i, i])
                for i in range(len(m))}

    # ------------------------------------------------------------- metrics
    def _tp(self) -> np.ndarray:
        return np.diag(self._matrix)

    def accuracy(self) -> float:
        m = self._matrix
        total = m.sum()
        return float(np.diag(m).sum() / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        """(ref: Evaluation.topNAccuracy — requires top_n > 1 at
        construction; equals accuracy() for top_n == 1)."""
        if self.top_n == 1:
            return self.accuracy()
        return self.top_n_correct / self.examples if self.examples else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        m = self._matrix
        col = m.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, np.diag(m) / np.maximum(col, 1), 0.0)
        if cls is not None:
            return float(per[cls])
        present = m.sum(axis=1) > 0
        return float(per[present].mean()) if present.any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        m = self._matrix
        row = m.sum(axis=1)
        per = np.where(row > 0, np.diag(m) / np.maximum(row, 1), 0.0)
        if cls is not None:
            return float(per[cls])
        present = row > 0
        return float(per[present].mean()) if present.any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def g_measure(self, cls: Optional[int] = None) -> float:
        """Geometric mean of precision and recall
        (ref: Evaluation.gMeasure / EvaluationUtils.gMeasure)."""
        p, r = self.precision(cls), self.recall(cls)
        return float(np.sqrt(p * r))

    def false_positive_rate(self, cls: int) -> float:
        m = self._matrix
        fp = m[:, cls].sum() - m[cls, cls]
        tn = m.sum() - m[cls, :].sum() - m[:, cls].sum() + m[cls, cls]
        return float(fp / (fp + tn)) if (fp + tn) else 0.0

    def false_negative_rate(self, cls: int) -> float:
        m = self._matrix
        fn = m[cls, :].sum() - m[cls, cls]
        tp = m[cls, cls]
        return float(fn / (fn + tp)) if (fn + tp) else 0.0

    def matthews_correlation(self, cls: Optional[int] = None) -> float:
        """Matthews correlation coefficient
        (ref: Evaluation.matthewsCorrelation / EvaluationUtils.matthews
        Correlation). Per-class = binary MCC of class-vs-rest; without a
        class argument the MULTICLASS generalization (R_k statistic)
        computed from the full confusion matrix."""
        m = self._matrix.astype(np.float64)
        if cls is not None:
            tp = m[cls, cls]
            fp = m[:, cls].sum() - tp
            fn = m[cls, :].sum() - tp
            tn = m.sum() - tp - fp - fn
            denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
            return float((tp * tn - fp * fn) / denom) if denom else 0.0
        c = np.trace(m)
        s = m.sum()
        t = m.sum(axis=1)  # actual counts
        p = m.sum(axis=0)  # predicted counts
        denom = np.sqrt(s * s - (p * p).sum()) * np.sqrt(s * s - (t * t).sum())
        return float((c * s - (t * p).sum()) / denom) if denom else 0.0

    def stats(self, suppress_warnings: bool = False) -> str:
        """Human-readable report with per-class breakdown
        (ref: Evaluation.stats():441-587)."""
        n = self.num_classes or 0
        names = self.label_names or [str(i) for i in range(n)]
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes: {n}",
                 f" Examples:     {self.examples}",
                 f" Accuracy:     {self.accuracy():.4f}"]
        if self.top_n > 1:
            lines.append(f" Top {self.top_n} Accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines += [f" Precision:    {self.precision():.4f}",
                  f" Recall:       {self.recall():.4f}",
                  f" F1 Score:     {self.f1():.4f}",
                  f" MCC:          {self.matthews_correlation():.4f}",
                  "",
                  " Per-class (one-vs-all):",
                  f"{'class':>8} {'prec':>7} {'recall':>7} {'f1':>7} "
                  f"{'mcc':>7} {'count':>7}"]
        m = self._matrix
        for i in range(n):
            lines.append(
                f"{names[i]:>8} {self.precision(i):>7.4f} "
                f"{self.recall(i):>7.4f} {self.f1(i):>7.4f} "
                f"{self.matthews_correlation(i):>7.4f} "
                f"{int(m[i, :].sum()) if n else 0:>7}")
        lines += ["", "Confusion matrix (rows=actual, cols=predicted):"]
        header = "      " + " ".join(f"{nm:>6}" for nm in names)
        lines.append(header)
        for i in range(n):
            lines.append(f"{names[i]:>6}" + " ".join(f"{m[i, j]:>6}" for j in range(n)))
        lines.append("==================================================================")
        return "\n".join(lines)
