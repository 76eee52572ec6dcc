"""DataSet iterators (the JAX package's ``datasets/iterator.py``: the
``DataSetIterator`` contract and ``ListDataSetIterator``). The
asynchronous prefetching iterator and the other adapters are not ported
yet (ROADMAP A7)."""

from __future__ import annotations

from typing import Iterator, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Iterator contract (ref: ND4J DataSetIterator interface, incl.
    setPreProcessor — a DataSetPreProcessor applied to every emitted
    batch)."""

    def reset(self) -> None:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def batch_size(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> Optional[int]:
        return None

    def async_supported(self) -> bool:
        return True

    def set_pre_processor(self, pre_processor) -> "DataSetIterator":
        """``pre_processor`` is a callable DataSet -> DataSet-or-None (None
        = mutated in place), applied by every consumption path: direct
        ``next()`` calls, ``__next__`` and ``__iter__``."""
        self._pre_processor = pre_processor
        if not getattr(self, "_pp_wrapped", False):
            raw_next = self.next

            def wrapped() -> DataSet:
                ds = raw_next()
                pp = getattr(self, "_pre_processor", None)
                if pp is not None:
                    out = pp(ds)
                    ds = ds if out is None else out
                return ds

            self.next = wrapped  # instance attr shadows the class method
            self._pp_wrapped = True
        return self

    # Python iteration protocol
    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()


class ListDataSetIterator(DataSetIterator):
    """Iterate over a pre-built list of minibatches
    (ref: datasets/iterator/impl/ListDataSetIterator.java)."""

    def __init__(self, batches: List[DataSet]):
        self._batches = list(batches)
        self._pos = 0

    @staticmethod
    def from_dataset(ds: DataSet, batch_size: int) -> "ListDataSetIterator":
        return ListDataSetIterator(ds.batch_by(batch_size))

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._batches)

    def next(self):
        b = self._batches[self._pos]
        self._pos += 1
        return b

    def batch_size(self):
        return self._batches[0].num_examples() if self._batches else 0

    def total_examples(self):
        return sum(b.num_examples() for b in self._batches)
