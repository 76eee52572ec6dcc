"""MNIST (the JAX package's ``datasets/mnist.py``, kept as its own numpy
copy): ``load_mnist`` and ``MnistDataSetIterator``.

The IDX files are read where they are found (``$MNIST_DIR``,
``~/.deeplearning4j_tpu/mnist`` or ``/tmp/mnist``; plain or ``.gz``).
Without them a deterministic synthetic stand-in with MNIST's shapes is
generated (``is_synthetic`` says which): each class a blurred random
template plus noise. The test split draws its templates from ``seed + 1``,
so they are not the training split's classes, and a net trained on one
split scores chance on the other by construction.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator

_SEARCH_PATHS = [
    Path(os.environ.get("MNIST_DIR", "")),
    Path.home() / ".deeplearning4j_tpu" / "mnist",
    Path("/tmp/mnist"),
]

_FILES = {
    "train_images": ["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"],
    "train_labels": ["train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"],
    "test_images": ["t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"],
    "test_labels": ["t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"],
}


def _find(names) -> Optional[Path]:
    for base in _SEARCH_PATHS:
        if not str(base):
            continue
        for n in names:
            p = base / n
            if p.exists():
                return p
    return None


def _read_idx(path: Path) -> np.ndarray:
    """An unsigned-byte IDX file as its uint8 array."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    if len(data) < 4 or data[:2] != b"\x00\x00" or data[2] != 0x08:
        raise ValueError(
            f"{path}: not an unsigned-byte IDX file (magic {data[:4]!r})")
    ndim = data[3]
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    return np.frombuffer(data, dtype=np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


def _synthetic_mnist(n: int, seed: int = 123
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured stand-in: each class is a blurred
    random template + noise, so models can learn to separate them."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0, 1, size=(10, 28, 28)).astype(np.float32)
    for _ in range(2):   # a cheap blur for spatial correlation
        templates = (templates
                     + np.roll(templates, 1, axis=1)
                     + np.roll(templates, -1, axis=1)
                     + np.roll(templates, 1, axis=2)
                     + np.roll(templates, -1, axis=2)) / 5.0
    # stretch each template to full [0, 1] contrast: blurring uniform
    # noise pulls everything toward 0.5, below the additive noise
    tmin = templates.min(axis=(1, 2), keepdims=True)
    tmax = templates.max(axis=(1, 2), keepdims=True)
    templates = (templates - tmin) / np.maximum(tmax - tmin, 1e-6)
    labels = rng.integers(0, 10, size=n)
    imgs = templates[labels] + 0.35 * rng.normal(
        size=(n, 28, 28)).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0).astype(np.float32)
    return imgs, labels


def load_mnist(train: bool = True, num_examples: Optional[int] = None,
               seed: int = 123) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(images [N, 28, 28] float32 in [0, 1], labels [N] int, synthetic?)."""
    img_key = "train_images" if train else "test_images"
    lab_key = "train_labels" if train else "test_labels"
    img_path, lab_path = _find(_FILES[img_key]), _find(_FILES[lab_key])
    if img_path is not None and lab_path is not None:
        imgs = _read_idx(img_path).astype(np.float32) / 255.0
        labels = _read_idx(lab_path).astype(np.int64)
        synthetic = False
    else:
        n = num_examples or (60000 if train else 10000)
        imgs, labels = _synthetic_mnist(n, seed + (0 if train else 1))
        synthetic = True
    if num_examples is not None:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    return imgs, labels, synthetic


class MnistDataSetIterator(ListDataSetIterator):
    """Features in [0, 1] and one-hot labels, shuffled with ``seed``:
    flattened ``[N, 784]``, or ``[N, 28, 28, 1]`` (NHWC) with
    ``flatten=False``."""

    def __init__(self, batch_size: int, num_examples: int = 60000,
                 train: bool = True, seed: int = 123, flatten: bool = True,
                 shuffle: bool = True):
        imgs, labels, self.is_synthetic = load_mnist(train, num_examples,
                                                     seed)
        feats = imgs.reshape(len(imgs), -1) if flatten else imgs[..., None]
        onehot = np.zeros((len(labels), 10), dtype=np.float32)
        onehot[np.arange(len(labels)), labels] = 1.0
        ds = DataSet(feats.astype(np.float32), onehot)
        if shuffle:
            ds = ds.shuffle(seed)
        super().__init__(ds.batch_by(batch_size))
