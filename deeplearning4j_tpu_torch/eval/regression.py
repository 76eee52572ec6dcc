"""Regression metrics per output column (the JAX package's
``eval/regression.py``).

Ref: eval/RegressionEvaluation.java — MSE, MAE, RMSE, RSE (relative squared
error), correlation R per column, accumulated over batches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, num_columns: Optional[int] = None):
        self.n = num_columns
        self._init_done = False

    def _ensure(self, n: int):
        if not self._init_done:
            self.n = self.n or n
            z = np.zeros(self.n)
            self.sum_err = z.copy()
            self.sum_abs_err = z.copy()
            self.sum_sq_err = z.copy()
            self.sum_label = z.copy()
            self.sum_sq_label = z.copy()
            self.sum_pred = z.copy()
            self.sum_sq_pred = z.copy()
            self.sum_label_pred = z.copy()
            self.count = 0
            self._init_done = True

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            B, T, C = labels.shape
            labels = labels.reshape(B * T, C)
            predictions = predictions.reshape(B * T, C)
            if mask is not None:
                keep = np.asarray(mask).reshape(B * T) > 0
                labels, predictions = labels[keep], predictions[keep]
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self.sum_err += err.sum(axis=0)
        self.sum_abs_err += np.abs(err).sum(axis=0)
        self.sum_sq_err += (err ** 2).sum(axis=0)
        self.sum_label += labels.sum(axis=0)
        self.sum_sq_label += (labels ** 2).sum(axis=0)
        self.sum_pred += predictions.sum(axis=0)
        self.sum_sq_pred += (predictions ** 2).sum(axis=0)
        self.sum_label_pred += (labels * predictions).sum(axis=0)
        self.count += len(labels)

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq_err[col] / self.count)

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.count)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def correlation_r2(self, col: int) -> float:
        n = self.count
        num = n * self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col]
        den_l = n * self.sum_sq_label[col] - self.sum_label[col] ** 2
        den_p = n * self.sum_sq_pred[col] - self.sum_pred[col] ** 2
        den = np.sqrt(den_l * den_p)
        r = num / den if den > 0 else 0.0
        return float(r)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_sq_err) / self.count)

    def stats(self) -> str:
        lines = ["Column   MSE          MAE          RMSE         R"]
        for c in range(self.n):
            lines.append(
                f"{c:<8} {self.mean_squared_error(c):<12.6f} "
                f"{self.mean_absolute_error(c):<12.6f} "
                f"{self.root_mean_squared_error(c):<12.6f} "
                f"{self.correlation_r2(c):.6f}")
        return "\n".join(lines)
