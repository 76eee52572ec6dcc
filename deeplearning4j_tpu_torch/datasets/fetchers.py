"""CIFAR-10, LFW and Curves dataset iterators (the JAX package's
``datasets/fetchers.py``).

Ref: deeplearning4j-core/.../datasets/fetchers/{CifarDataFetcher,
LFWDataFetcher,CurvesDataFetcher}.java and iterator/impl/
{CifarDataSetIterator,LFWDataSetIterator}.java. The reference downloads
archives and routes images through DataVec's image loader; here local
files are parsed when present and a deterministic class-structured
synthetic stand-in is generated otherwise (zero-egress environment), the
same policy as datasets/mnist.py. ``is_synthetic`` reports which path ran.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator


def _search(env: str, *names: str) -> Optional[Path]:
    env_val = os.environ.get(env, "")
    bases = ([Path(env_val)] if env_val else []) + [
        Path.home() / ".deeplearning4j_tpu", Path("/tmp")]
    for base in bases:
        for n in names:
            p = base / n
            if p.exists():
                return p
    # cloud fallback (DL4J_TPU_DATA_URL=gs://... — ref: deeplearning4j-aws
    # S3 dataset readers)
    from deeplearning4j_tpu_torch.datasets import cloud_io
    return cloud_io.search_data_url(*names)


def _synthetic_images(n: int, classes: int, h: int, w: int, c: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Blurred per-class templates + noise (learnable, deterministic)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 1, size=(classes, h, w, c)).astype(np.float32)
    for _ in range(2):
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)
             + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5.0
    labels = rng.integers(0, classes, size=n)
    x = t[labels] + 0.3 * rng.normal(size=(n, h, w, c)).astype(np.float32)
    return np.clip(x, 0, 1).astype(np.float32), labels


# ---------------------------------------------------------------------------
# CIFAR-10
# ---------------------------------------------------------------------------

def load_cifar10(train: bool = True, num_examples: Optional[int] = None,
                 seed: int = 7) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (images [N,32,32,3] float32 in [0,1], labels [N], synthetic?).
    Parses the python-pickle batches of the official archive when a
    ``cifar-10-batches-py`` directory is found."""
    root = _search("CIFAR10_DIR", "cifar-10-batches-py", "cifar10")
    if root is not None and root.is_dir():
        files = ([root / f"data_batch_{i}" for i in range(1, 6)] if train
                 else [root / "test_batch"])
        xs, ys = [], []
        for f in files:
            if not f.exists():
                break
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.extend(d[b"labels"])
        else:
            x = (np.concatenate(xs).reshape(-1, 3, 32, 32)
                 .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
            y = np.asarray(ys)
            if num_examples:
                x, y = x[:num_examples], y[:num_examples]
            return x, y, False
    n = num_examples or (50000 if train else 10000)
    n = min(n, 4096)  # synthetic stand-in stays small
    x, y = _synthetic_images(n, 10, 32, 32, 3, seed + (0 if train else 1))
    return x, y, True


class CifarDataSetIterator(ListDataSetIterator):
    """ref: iterator/impl/CifarDataSetIterator.java."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, num_examples: int = 50000,
                 train: bool = True, seed: int = 7):
        x, labels, self.is_synthetic = load_cifar10(train, num_examples, seed)
        y = np.zeros((len(labels), 10), np.float32)
        y[np.arange(len(labels)), labels] = 1.0
        super().__init__(DataSet(x, y).batch_by(batch_size))


# ---------------------------------------------------------------------------
# LFW (faces)
# ---------------------------------------------------------------------------

def load_lfw(num_examples: Optional[int] = None, height: int = 64,
             width: int = 64, classes: int = 20, seed: int = 11
             ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """LFW-style face classification: images from an ``lfw`` directory tree
    (person-per-subdir, via ImageRecordReader) or synthetic stand-in."""
    root = _search("LFW_DIR", "lfw", "lfw-deepfunneled")
    if root is not None and root.is_dir():
        from deeplearning4j_tpu_torch.datasets.records import ImageRecordReader
        try:
            rr = ImageRecordReader(root, height, width, 3)
            if rr._files:
                xs, ys = [], []
                for rec in rr:
                    xs.append(np.asarray(rec[:-1], np.float32)
                              .reshape(height, width, 3) / 255.0)
                    ys.append(int(rec[-1]))
                    if num_examples and len(xs) >= num_examples:
                        break
                return np.stack(xs), np.asarray(ys), False
        except RuntimeError:
            pass  # no PIL for jpgs → synthetic
    n = min(num_examples or 1024, 2048)
    x, y = _synthetic_images(n, classes, height, width, 3, seed)
    return x, y, True


class LFWDataSetIterator(ListDataSetIterator):
    """ref: iterator/impl/LFWDataSetIterator.java."""

    def __init__(self, batch_size: int, num_examples: int = 1024,
                 height: int = 64, width: int = 64, classes: int = 20,
                 seed: int = 11):
        x, labels, self.is_synthetic = load_lfw(num_examples, height, width,
                                                classes, seed)
        n_cls = int(labels.max()) + 1
        y = np.zeros((len(labels), n_cls), np.float32)
        y[np.arange(len(labels)), labels] = 1.0
        super().__init__(DataSet(x, y).batch_by(batch_size))


# ---------------------------------------------------------------------------
# Curves (the DBN-era synthetic curves dataset)
# ---------------------------------------------------------------------------

def load_curves(n: int = 2000, dim: int = 784, seed: int = 13
                ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """The reference's curves set is a download of synthetic curve images
    used for autoencoder pretraining (ref: CurvesDataFetcher.java). Features
    double as labels (reconstruction task). Generated here directly: random
    smooth 1-D curves rendered into a flattened 28x28 canvas."""
    rng = np.random.default_rng(seed)
    side = int(round(dim ** 0.5))
    xs = np.zeros((n, side, side), np.float32)
    t = np.linspace(0, 1, side)
    for i in range(n):
        coeff = rng.normal(size=4) * 0.3
        ys = (coeff[0] + coeff[1] * t + coeff[2] * np.sin(3 * np.pi * t)
              + coeff[3] * np.cos(2 * np.pi * t))
        ys = (ys - ys.min()) / max(np.ptp(ys), 1e-6) * (side - 1)
        cols = np.arange(side)
        rows = np.clip(ys.round().astype(int), 0, side - 1)
        xs[i, rows, cols] = 1.0
        xs[i, np.clip(rows + 1, 0, side - 1), cols] = 0.5
    flat = xs.reshape(n, side * side)
    return flat, flat.copy(), True


class CurvesDataSetIterator(ListDataSetIterator):
    """ref: datasets/fetchers/CurvesDataFetcher.java (features == labels)."""

    def __init__(self, batch_size: int, num_examples: int = 2000,
                 seed: int = 13):
        x, y, self.is_synthetic = load_curves(num_examples, seed=seed)
        super().__init__(DataSet(x, y).batch_by(batch_size))
