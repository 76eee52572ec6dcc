"""Record readers and record→DataSet iterators, the DataVec bridge (the
JAX package's ``datasets/records.py``).

The reference feeds training from DataVec ``RecordReader``s through
``RecordReaderDataSetIterator`` (ref: deeplearning4j-core/.../datasets/
datavec/RecordReaderDataSetIterator.java), the multi-input variant
``RecordReaderMultiDataSetIterator`` (same dir) and the sequence variant
``SequenceRecordReaderDataSetIterator``. This module provides the same
capability: readers yield per-record value lists; iterators pack them
into dense numpy batches (sequence batches are padded to the batch's
longest sequence, with mask arrays: the framework-wide masking
convention). The containers copy them to their device at the step.

No external DataVec: CSV/line/collection/image readers are implemented
here directly.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

Record = List[Union[float, int, str]]


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _read_text(source) -> str:
    """Read a text source: local path or cloud URL (gs:// s3:// http(s)://
    via datasets/cloud_io — ref: deeplearning4j-aws s3 readers)."""
    from deeplearning4j_tpu_torch.datasets import cloud_io
    if cloud_io.is_cloud_url(source):
        return cloud_io.read_url(str(source)).decode("utf-8")
    with open(source, encoding="utf-8") as f:
        return f.read()


class RecordReader:
    """One record per ``next_record()`` call; a record is a list of values
    (the Writable-list contract of the reference's readers)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self) -> Record:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()


class CollectionRecordReader(RecordReader):
    """In-memory records (ref: DataVec CollectionRecordReader)."""

    def __init__(self, records: Sequence[Record]):
        self._records = [list(r) for r in records]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return r

    def reset(self):
        self._pos = 0


class CSVRecordReader(RecordReader):
    """Parse delimited text into numeric-where-possible records
    (ref: DataVec CSVRecordReader). Accepts a path or an iterable of lines."""

    def __init__(self, source: Union[str, Path, Iterable[str]],
                 skip_lines: int = 0, delimiter: str = ","):
        self._rows = None  # native numeric fast path: float32 [rows, cols]
        if isinstance(source, (str, Path)):
            from deeplearning4j_tpu_torch.datasets import cloud_io
            if not cloud_io.is_cloud_url(source):
                # all-numeric LOCAL files parse in native code
                # (native/dataloader.cc csv_read); mixed/string content
                # and cloud URLs fall back to the Python tokenizer below
                from deeplearning4j_tpu_torch.datasets import native_io
                parsed = native_io.csv_read(source, delimiter=delimiter,
                                            skip_rows=skip_lines)
                if parsed is not None:
                    self._rows = parsed[0]
                    self._lines = []
                    self._delim = delimiter
                    self._pos = 0
                    return
            lines = _read_text(source).splitlines()
        else:
            lines = [l.rstrip("\n") for l in source]
        self._lines = [l for l in lines[skip_lines:] if l.strip()]
        self._delim = delimiter
        self._pos = 0

    @staticmethod
    def _parse(tok: str) -> Union[float, str]:
        tok = tok.strip()
        try:
            return float(tok)
        except ValueError:
            return tok

    def has_next(self):
        n = len(self._rows) if self._rows is not None else len(self._lines)
        return self._pos < n

    def next_record(self):
        if self._rows is not None:
            row = self._rows[self._pos]
            self._pos += 1
            return [float(v) for v in row]
        toks = self._lines[self._pos].split(self._delim)
        self._pos += 1
        return [self._parse(t) for t in toks]

    def reset(self):
        self._pos = 0


class LineRecordReader(RecordReader):
    """One line = one single-value record (ref: DataVec LineRecordReader)."""

    def __init__(self, source: Union[str, Path, Iterable[str]]):
        if isinstance(source, (str, Path)):
            self._lines = _read_text(source).splitlines()
        else:
            self._lines = [l.rstrip("\n") for l in source]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._lines)

    def next_record(self):
        l = self._lines[self._pos]
        self._pos += 1
        return [l]

    def reset(self):
        self._pos = 0


class SequenceRecordReader:
    """One *sequence* (list of records) per call — the contract behind
    tBPTT data feeds (ref: DataVec SequenceRecordReader)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sequence(self) -> List[Record]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Record]]):
        self._seqs = [[list(r) for r in s] for s in sequences]
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._seqs)

    def next_sequence(self):
        s = self._seqs[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence, or one source with blank-line-separated
    sequences (ref: DataVec CSVSequenceRecordReader)."""

    def __init__(self, sources: Union[Sequence[Union[str, Path]], str, Path],
                 skip_lines: int = 0, delimiter: str = ","):
        self._seqs: List[List[Record]] = []
        if isinstance(sources, (str, Path)):
            sources = [sources]
        for src in sources:
            text = _read_text(src)
            # header skip applies once per source, not per sequence chunk
            text = "\n".join(text.splitlines()[skip_lines:])
            for chunk in text.split("\n\n"):
                lines = [l for l in chunk.splitlines() if l.strip()]
                if lines:
                    self._seqs.append(
                        [[CSVRecordReader._parse(t) for t in l.split(delimiter)]
                         for l in lines])
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._seqs)

    def next_sequence(self):
        s = self._seqs[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


class ImageRecordReader(RecordReader):
    """Images from a directory tree; label appended from the parent
    directory name (ref: DataVec ImageRecordReader used by the CIFAR/LFW
    fetchers). Supports ``.npy`` arrays always; PNG/JPEG when PIL is
    importable (probe-and-fallback, the native-loader pattern)."""

    def __init__(self, root: Union[str, Path], height: int, width: int,
                 channels: int = 3, append_label: bool = True,
                 extensions: Tuple[str, ...] = (".npy", ".png", ".jpg",
                                                ".jpeg", ".bmp")):
        self.height, self.width, self.channels = height, width, channels
        self._append_label = append_label
        root = Path(root)
        self._files = sorted(p for p in root.rglob("*")
                             if p.suffix.lower() in extensions)
        self.labels = sorted({p.parent.name for p in self._files})
        self._label_idx = {n: i for i, n in enumerate(self.labels)}
        self._pos = 0

    def _load(self, path: Path) -> np.ndarray:
        if path.suffix == ".npy":
            arr = np.load(path)
        else:
            try:
                from PIL import Image
            except ImportError as e:
                raise RuntimeError(
                    f"PIL unavailable; cannot read {path}. Use .npy") from e
            img = Image.open(path).resize((self.width, self.height))
            arr = np.asarray(img)
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] != self.channels:
            if arr.shape[-1] == 1:          # grayscale → replicate
                arr = np.repeat(arr, self.channels, axis=-1)
            elif arr.shape[-1] > self.channels:  # e.g. RGBA → RGB
                arr = arr[..., :self.channels]
            else:
                raise ValueError(f"{path}: {arr.shape[-1]} channels, "
                                 f"need {self.channels}")
        if arr.shape[:2] != (self.height, self.width):
            raise ValueError(f"{path}: shape {arr.shape} != "
                             f"({self.height},{self.width},·)")
        return arr

    def has_next(self):
        return self._pos < len(self._files)

    def next_record(self):
        p = self._files[self._pos]
        self._pos += 1
        rec: Record = list(self._load(p).ravel())
        if self._append_label:
            rec.append(self._label_idx[p.parent.name])
        return rec

    def reset(self):
        self._pos = 0


# ---------------------------------------------------------------------------
# record → DataSet iterators
# ---------------------------------------------------------------------------

def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((len(idx), n), np.float32)
    out[np.arange(len(idx)), idx.astype(int)] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """records → classification/regression DataSets
    (ref: datasets/datavec/RecordReaderDataSetIterator.java: labelIndex /
    numPossibleLabels / regression semantics, incl. labelIndexFrom/To for
    multi-column regression targets).

    ``label_index=-1`` (default: last column). ``regression=False`` one-hots
    the label column; regression with ``label_index_to`` takes an inclusive
    column range as the target.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_possible_labels: int = -1,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self._reader = reader
        self._batch = batch_size
        self._label_index = label_index
        self._num_labels = num_possible_labels
        self._regression = regression
        self._label_to = label_index_to
        self._image_shape = None
        if isinstance(reader, ImageRecordReader):
            self._image_shape = (reader.height, reader.width, reader.channels)
            if self._num_labels < 0:
                self._num_labels = len(reader.labels)

    def reset(self):
        self._reader.reset()

    def has_next(self):
        return self._reader.has_next()

    def batch_size(self):
        return self._batch

    def _split(self, rec: Record) -> Tuple[List[float], List[float]]:
        li = self._label_index if self._label_index >= 0 else len(rec) - 1
        if self._regression and self._label_to is not None:
            labels = rec[li:self._label_to + 1]
            feats = rec[:li] + rec[self._label_to + 1:]
        else:
            labels = [rec[li]]
            feats = rec[:li] + rec[li + 1:]
        return [float(v) for v in feats], [float(v) for v in labels]

    def next(self) -> DataSet:
        feats, labels = [], []
        while self._reader.has_next() and len(feats) < self._batch:
            f, l = self._split(self._reader.next_record())
            feats.append(f)
            labels.append(l)
        x = np.asarray(feats, np.float32)
        if self._image_shape is not None:
            x = x.reshape((len(feats),) + self._image_shape)
        y = np.asarray(labels, np.float32)
        if not self._regression:
            n = self._num_labels
            if n < 0:
                raise ValueError("num_possible_labels required for "
                                 "classification")
            y = _one_hot(y[:, 0], n)
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequences → padded+masked [B, T, F] DataSets (ref: datasets/datavec/
    SequenceRecordReaderDataSetIterator.java). Two modes:

    - separate feature/label readers (``labels_reader`` given), aligned
      ALIGN_START or ALIGN_END — the reference's AlignmentMode;
    - single reader with the label as the last column of each timestep.

    Batches are padded to the longest sequence in the batch, with
    features_mask/labels_mask marking valid steps, mask semantics
    identical to the reference.
    """

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 num_possible_labels: int = -1, regression: bool = False,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 alignment: str = "align_start"):
        if alignment not in ("align_start", "align_end"):
            raise ValueError(f"Unknown alignment {alignment!r}")
        if not regression and num_possible_labels < 0:
            raise ValueError("num_possible_labels required for "
                             "classification")
        self._reader = reader
        self._labels_reader = labels_reader
        self._batch = batch_size
        self._num_labels = num_possible_labels
        self._regression = regression
        self._alignment = alignment

    def reset(self):
        self._reader.reset()
        if self._labels_reader is not None:
            self._labels_reader.reset()

    def has_next(self):
        if self._labels_reader is not None \
                and not self._labels_reader.has_next():
            return False
        return self._reader.has_next()

    def batch_size(self):
        return self._batch

    def next(self) -> DataSet:
        f_seqs, l_seqs = [], []
        while self.has_next() and len(f_seqs) < self._batch:
            seq = self._reader.next_sequence()
            if self._labels_reader is not None:
                f_seqs.append([[float(v) for v in r] for r in seq])
                l_seqs.append([[float(v) for v in r]
                               for r in self._labels_reader.next_sequence()])
            else:
                f_seqs.append([[float(v) for v in r[:-1]] for r in seq])
                l_seqs.append([[float(r[-1])] for r in seq])
        B = len(f_seqs)
        T = max(max(len(s) for s in f_seqs), max(len(s) for s in l_seqs))
        nf = len(f_seqs[0][0])
        nl = (self._num_labels if not self._regression
              else len(l_seqs[0][0]))
        x = np.zeros((B, T, nf), np.float32)
        y = np.zeros((B, T, nl), np.float32)
        fm = np.zeros((B, T), np.float32)
        lm = np.zeros((B, T), np.float32)
        for i, (fs, ls) in enumerate(zip(f_seqs, l_seqs)):
            f_off = T - len(fs) if self._alignment == "align_end" else 0
            l_off = T - len(ls) if self._alignment == "align_end" else 0
            x[i, f_off:f_off + len(fs)] = fs
            fm[i, f_off:f_off + len(fs)] = 1.0
            lm[i, l_off:l_off + len(ls)] = 1.0
            if self._regression:
                y[i, l_off:l_off + len(ls)] = ls
            else:
                for t, row in enumerate(ls):
                    y[i, l_off + t] = _one_hot(np.asarray(row[:1]),
                                               self._num_labels)[0]
        return DataSet(x, y, fm, lm)


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Multiple named readers → MultiDataSet for ComputationGraph training
    (ref: datasets/datavec/RecordReaderMultiDataSetIterator.java and its
    Builder: addReader / addInput(col range) / addOutput /
    addOutputOneHot)."""

    class Builder:
        def __init__(self, batch_size: int):
            self._batch = batch_size
            self._readers: Dict[str, RecordReader] = {}
            self._inputs: List[Tuple[str, Optional[int], Optional[int]]] = []
            self._outputs: List[Tuple[str, Optional[int], Optional[int],
                                      Optional[int]]] = []

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_input(self, reader_name: str, col_from: Optional[int] = None,
                      col_to: Optional[int] = None):
            self._inputs.append((reader_name, col_from, col_to))
            return self

        def add_output(self, reader_name: str, col_from: Optional[int] = None,
                       col_to: Optional[int] = None):
            self._outputs.append((reader_name, col_from, col_to, None))
            return self

        def add_output_one_hot(self, reader_name: str, column: int,
                               num_classes: int):
            self._outputs.append((reader_name, column, column, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            for name, *_ in self._inputs + self._outputs:
                if name not in self._readers:
                    raise ValueError(f"No reader named {name!r}")
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        self._b = builder

    def reset(self):
        for r in self._b._readers.values():
            r.reset()

    def has_next(self):
        return all(r.has_next() for r in self._b._readers.values())

    def batch_size(self):
        return self._b._batch

    def next(self) -> MultiDataSet:
        rows: Dict[str, List[Record]] = {n: [] for n in self._b._readers}
        count = 0
        while self.has_next() and count < self._b._batch:
            for name, reader in self._b._readers.items():
                rows[name].append(reader.next_record())
            count += 1

        def cols(spec_rows, cf, ct):
            arr = np.asarray([[float(v) for v in r] for r in spec_rows],
                             np.float32)
            if cf is None:
                return arr
            return arr[:, cf:(ct + 1 if ct is not None else cf + 1)]

        feats = [cols(rows[n], cf, ct) for n, cf, ct in self._b._inputs]
        labels = []
        for n, cf, ct, n_classes in self._b._outputs:
            arr = cols(rows[n], cf, ct)
            if n_classes is not None:
                arr = _one_hot(arr[:, 0], n_classes)
            labels.append(arr)
        return MultiDataSet(features=feats, labels=labels)
