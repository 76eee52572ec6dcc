"""DataSet containers (the JAX package's ``datasets/dataset.py``).

ND4J's ``DataSet`` (features, labels, feature mask, label mask) and
``MultiDataSet`` (lists of each). Arrays are host-side numpy; the
containers move them to the net's device at the step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        tr = DataSet(self.features[:n_train], self.labels[:n_train],
                     None if self.features_mask is None
                     else self.features_mask[:n_train],
                     None if self.labels_mask is None
                     else self.labels_mask[:n_train])
        te = DataSet(self.features[n_train:], self.labels[n_train:],
                     None if self.features_mask is None
                     else self.features_mask[n_train:],
                     None if self.labels_mask is None
                     else self.labels_mask[n_train:])
        return tr, te

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        n = self.num_examples()
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            out.append(DataSet(
                self.features[sl], self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl]))
        return out

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            (np.concatenate([d.features_mask for d in datasets])
             if datasets[0].features_mask is not None else None),
            (np.concatenate([d.labels_mask for d in datasets])
             if datasets[0].labels_mask is not None else None))


@dataclass
class MultiDataSet:
    """Multiple-input/multiple-output batch for ComputationGraph training
    (ref: ND4J MultiDataSet consumed by ComputationGraph.fit)."""
    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
