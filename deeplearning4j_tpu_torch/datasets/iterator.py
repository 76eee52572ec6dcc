"""DataSet iterators (the JAX package's ``datasets/iterator.py``).

The reference's iterator stack: the ``DataSetIterator`` contract (ND4J
interface), ``AsyncDataSetIterator`` (a background prefetch thread and a
bounded queue, ref: deeplearning4j-nn/.../datasets/iterator/
AsyncDataSetIterator.java:33-75), the adapters under datasets/iterator/
(``ListDataSetIterator``, ``SamplingDataSetIterator``,
``MultipleEpochsIterator``, ``ExistingDataSetIterator``), and
``DevicePrefetchIterator``, which stages each batch in card memory from
its producer thread: the batch is cast on the host, copied into pinned
memory and sent to the card on a side stream, so the copy overlaps the
previous step; the consumer's stream waits on the copy's event
(``DeviceStager``, which the streaming input pipeline's device stage
shares). ``fit()`` wraps an iterator in ``AsyncDataSetIterator`` as
MultiLayerNetwork.fit does (ref: MultiLayerNetwork.java:951).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


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


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any Python iterable of DataSets
    (ref: datasets/iterator/ExistingDataSetIterator.java)."""

    def __init__(self, iterable):
        self._iterable = iterable
        self._it = None
        self._peek: Optional[DataSet] = None

    def reset(self):
        self._it = iter(self._iterable)
        self._peek = None

    def _ensure(self):
        if self._it is None:
            self.reset()
        if self._peek is None:
            try:
                self._peek = next(self._it)
            except StopIteration:
                self._peek = None

    def has_next(self):
        self._ensure()
        return self._peek is not None

    def next(self):
        self._ensure()
        if self._peek is None:
            raise StopIteration
        out, self._peek = self._peek, None
        return out

    def batch_size(self):
        return 0


class SamplingDataSetIterator(DataSetIterator):
    """Sample minibatches with replacement from a full DataSet
    (ref: datasets/iterator/SamplingDataSetIterator.java)."""

    def __init__(self, dataset: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self._ds = dataset
        self._bs = batch_size
        self._total = total_batches
        self._count = 0
        self._rng = np.random.default_rng(seed)

    def reset(self):
        self._count = 0

    def has_next(self):
        return self._count < self._total

    def next(self):
        idx = self._rng.integers(0, self._ds.num_examples(), size=self._bs)
        self._count += 1
        return DataSet(self._ds.features[idx], self._ds.labels[idx])

    def batch_size(self):
        return self._bs


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an underlying iterator for N epochs
    (ref: datasets/iterator/MultipleEpochsIterator.java)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self._epochs = epochs
        self._base = base
        self._epoch = 0

    def reset(self):
        self._epoch = 0
        self._base.reset()

    def has_next(self):
        if self._base.has_next():
            return True
        if self._epoch + 1 < self._epochs:
            self._epoch += 1
            self._base.reset()
            return self._base.has_next()
        return False

    def next(self):
        if not self.has_next():
            raise StopIteration
        return self._base.next()

    def batch_size(self):
        return self._base.batch_size()


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch thread + bounded queue
    (ref: AsyncDataSetIterator.java:33-75: a producer thread fills a
    BlockingQueue of size ``queue_size``; a terminal item on exhaustion).
    ``close()`` (or draining to the end) joins the thread; ``reset()``
    joins the old producer before starting a new one."""

    def __init__(self, base: DataSetIterator, queue_size: int = 8):
        self._base = base
        self._queue_size = queue_size
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._peek = None  # ("data", ds) | ("error", exc) | ("end", None)
        self._done = False
        self._start()

    def _produce(self, ds: DataSet):
        """What the queue carries for one base batch."""
        return ds

    def _consume(self, item) -> DataSet:
        """The batch the consumer gets for one queue item (on the
        consumer's thread)."""
        return item

    def _producer(self, q: "queue.Queue"):
        # In-order tagged items: already-produced batches are consumed
        # before an error is raised, and the stream always terminates.
        try:
            while self._base.has_next():
                q.put(("data", self._produce(self._base.next())))
            q.put(("end", None))
        except BaseException as e:  # surfaced, in order, on the consumer side
            q.put(("error", e))

    def _start(self):
        self._done = False
        self._thread = threading.Thread(target=self._producer,
                                        args=(self._queue,), daemon=True,
                                        name="dl4j-async-iterator")
        self._thread.start()

    def _drain(self):
        """Take items until the terminal one, so a producer parked on a
        full queue can finish, then join it."""
        while True:
            tag, _ = self._queue.get()
            if tag in ("end", "error"):
                break
        self._thread.join()

    def reset(self):
        if self._thread is not None and self._thread.is_alive():
            # drain so the producer can exit; unless the terminal item
            # was already taken into _peek (then the queue may be empty)
            if self._peek is None or self._peek[0] == "data":
                self._drain()
            else:
                self._thread.join()
        self._queue = queue.Queue(maxsize=self._queue_size)
        self._peek = None
        self._base.reset()
        self._start()

    def close(self):
        """Release the producer thread (it may be parked on a full queue)
        and join it. The iterator is exhausted afterwards; use reset()
        instead to start another epoch."""
        if self._thread is not None and self._thread.is_alive():
            # drain until the terminal item UNLESS it was already pulled
            # into _peek (then the producer is already exiting and the
            # queue may be empty: draining would block forever)
            if self._peek is None or self._peek[0] == "data":
                self._drain()
            else:
                self._thread.join()
        self._thread = None
        self._peek = None
        self._done = True

    def _ensure(self):
        if self._peek is None and not self._done:
            self._peek = self._queue.get()

    def has_next(self):
        if self._done:
            return False
        self._ensure()
        tag, payload = self._peek
        if tag == "error":  # propagate instead of silently ending the epoch
            self._done = True
            raise payload
        return tag == "data"

    def next(self):
        if self._done:
            raise StopIteration
        self._ensure()
        tag, payload = self._peek
        if tag == "data":
            self._peek = None
            return self._consume(payload)
        # terminal item: mark exhausted so subsequent calls never block
        self._done = True
        if tag == "error":
            raise payload
        raise StopIteration

    def batch_size(self):
        return self._base.batch_size()


class DeviceStager:
    """Stages host batches on a device: the host-to-card double buffer
    that ``DevicePrefetchIterator`` and the streaming input pipeline's
    device stage (``datasets/pipeline.py``) share.

    :meth:`stage` runs on the producer's thread: each array is cast on the
    host first (numpy has no bf16, so the cast runs in torch on the host
    tensor, and a bf16 batch crosses PCIe at half the bytes), copied into
    pinned memory and sent to the card with a non-blocking copy on the
    stager's own CUDA stream, which it makes once, on the device, at its
    first batch; so the copy overlaps the step that runs meanwhile. The
    event recorded after the copies travels with the batch: :meth:`ready`,
    on the consumer's thread, makes the consumer's current stream wait on
    it and marks each tensor as used by that stream, so the caching
    allocator does not hand its memory back to the side stream while the
    step reads it. Each batch gets its own pinned buffers, which the
    pinned allocator keeps until their copy is done, so no buffer is
    rewritten while its copy is in flight.

    On the CPU the arrays become host tensors (cast the same way). Masks
    are not cast; features and labels are. A batch's ``data_ranks`` mark
    travels with it."""

    def __init__(self, device, dtype: Optional[str] = None):
        self.device = torch.device(device)
        self.dtype = None if dtype is None else getattr(torch, str(dtype))
        self._stream = None

    def _put(self, arr, cast: bool):
        if arr is None:
            return None
        t = torch.as_tensor(np.asarray(arr)) if not isinstance(
            arr, torch.Tensor) else arr
        if cast and self.dtype is not None and t.is_floating_point():
            t = t.to(self.dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _copy(self, ds):
        if isinstance(ds, MultiDataSet):
            return MultiDataSet(
                [self._put(f, True) for f in ds.features],
                [self._put(y, True) for y in ds.labels],
                None if ds.features_masks is None
                else [self._put(m, False) for m in ds.features_masks],
                None if ds.labels_masks is None
                else [self._put(m, False) for m in ds.labels_masks],
                data_ranks=ds.data_ranks)
        return DataSet(self._put(ds.features, True),
                       self._put(ds.labels, True),
                       self._put(ds.features_mask, False),
                       self._put(ds.labels_mask, False),
                       data_ranks=ds.data_ranks)

    def stage(self, ds):
        """(the batch's tensors on the device, the copy's event or None)."""
        if self.device.type != "cuda":
            return self._copy(ds), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            staged = self._copy(ds)
            done = torch.cuda.Event()
            done.record(self._stream)
        return staged, done

    def ready(self, item):
        """The staged batch of :meth:`stage`'s ``item``, safe to read on
        the calling thread's current stream."""
        ds, done = item
        if done is None:
            return ds
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in _tensors(ds):
            t.record_stream(stream)
        return ds


def _tensors(ds) -> list:
    """Every array of a DataSet or MultiDataSet (masks too)."""
    if isinstance(ds, MultiDataSet):
        arrays = [*ds.features, *ds.labels, *(ds.features_masks or ()),
                  *(ds.labels_masks or ())]
    else:
        arrays = [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
    return [a for a in arrays if a is not None]


class DevicePrefetchIterator(AsyncDataSetIterator):
    """Async prefetch that also stages each batch in device memory (with
    an optional cast of its float arrays) from the producer thread: a
    double-buffered host-to-card feed (SURVEY section 7; the reference's
    device-affinity prefetch is AsyncDataSetIterator.java:45), through a
    :class:`DeviceStager` (pinned memory, a side stream, an event the
    consumer's stream waits on).

    ``device=None`` is the card and raises without one; ``"cpu"`` stages
    host tensors (the tests). Feature masks are not cast (labels are, as
    in the JAX iterator). It is asynchronous already, so ``fit`` does not
    wrap it in another ``AsyncDataSetIterator`` (``async_supported`` is
    False), and the stream wait runs on the training thread."""

    def __init__(self, base: DataSetIterator, queue_size: int = 2,
                 dtype: Optional[str] = None, device=None):
        from deeplearning4j_tpu_torch.device import resolve_device
        self._stager = DeviceStager(resolve_device(device), dtype)
        super().__init__(base, queue_size=queue_size)

    def async_supported(self) -> bool:
        return False

    def _produce(self, ds: DataSet):
        return self._stager.stage(ds)

    def _consume(self, item) -> DataSet:
        return self._stager.ready(item)
