"""DataSet containers (the JAX package's ``datasets/dataset.py``).

ND4J's ``DataSet`` (features, labels, feature mask, label mask) and
``MultiDataSet`` (lists of each). Arrays are host-side numpy (or tensors
a device stage put on the card); the containers move them to the net's
device at the step.

``data_ranks`` says whose rows a batch holds. ``None`` (the default): a
global batch, which ``ParallelTrainer`` cuts to each data rank's rows.
``n``: this data rank's rows of a global batch spread over ``n`` data
ranks, as the streaming input pipeline stages them for a mesh and
``multihost.global_array`` marks them; the trainer cuts no rows of such
a batch (only its microbatches, and T on an sp axis). Cutting a batch's
rows (``batch_by``, ``split_test_and_train``, ``shuffle``) makes batches
without the mark.
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
    data_ranks: Optional[int] = field(default=None, compare=False)

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


def global_rows(batch) -> int:
    """The rows of the global batch ``batch`` belongs to: its own, or,
    marked ``data_ranks = n``, n times its own."""
    return batch.num_examples() * (batch.data_ranks or 1)


@dataclass
class MultiDataSet:
    """Multiple-input/multiple-output batch for ComputationGraph training
    (ref: ND4J MultiDataSet consumed by ComputationGraph.fit)."""
    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None
    data_ranks: Optional[int] = field(default=None, compare=False)

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
