"""Iris dataset (the JAX package's ``datasets/iris.py``; ref:
deeplearning4j-core/.../datasets/fetchers/IrisDataFetcher.java — the
reference embeds the classic 150-example table).

A deterministic generator reproduces the three-cluster structure with
the published per-class means/stds, drawn from numpy's ``default_rng``
exactly as the JAX package draws it, so both packages get the same
150 examples from the same seed."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator

# per-class (mean, std) of [sepal_len, sepal_wid, petal_len, petal_wid]
_CLASS_STATS = [
    ((5.006, 3.428, 1.462, 0.246), (0.352, 0.379, 0.174, 0.105)),  # setosa
    ((5.936, 2.770, 4.260, 1.326), (0.516, 0.314, 0.470, 0.198)),  # versicolor
    ((6.588, 2.974, 5.552, 2.026), (0.636, 0.322, 0.552, 0.275)),  # virginica
]


def load_iris(seed: int = 6) -> DataSet:
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for cls, (mean, std) in enumerate(_CLASS_STATS):
        x = rng.normal(mean, std, size=(50, 4))
        feats.append(x)
        labels.extend([cls] * 50)
    features = np.concatenate(feats).astype(np.float32)
    onehot = np.zeros((150, 3), dtype=np.float32)
    onehot[np.arange(150), labels] = 1.0
    ds = DataSet(features, onehot)
    return ds.shuffle(seed)


class IrisDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 6):
        ds = load_iris(seed)
        ds = DataSet(ds.features[:num_examples], ds.labels[:num_examples])
        super().__init__(ds.batch_by(batch_size))
