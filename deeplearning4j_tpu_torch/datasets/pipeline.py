"""Sharded streaming input pipeline: feed the card, measure the stall
(the JAX package's ``datasets/pipeline.py``).

A single Python producer thread per process (``AsyncDataSetIterator``)
decodes and ships batches serially, the classic JVM-framework training
profile of "Towards High Performance Java-based Deep Learning
Frameworks" (arxiv 2001.04206). This module composes the existing seams
into a staged pipeline:

    sources ──> [read × R] ──> [decode × D] ──> reorder ──> [h2d] ──> next()
    (per-rank      parallel        parallel      (source     pinned side-
     disjoint      file/cloud      native C++     order)     stream copy
     shard)        range reads     IDX/CSV or                onto the card
                                   Python parse              (this rank's
                                                              rows)

- **Source sharding**: the source list is split into disjoint strided
  shards. With a mesh, a rank takes shard ``mesh.data_index`` of
  ``mesh.n_data`` (the model, sp and pp ranks of one data index read the
  same rows); without one, shard ``process_index()`` of
  ``process_count()`` of ``multihost``, resolved once at the first
  iteration. No two data ranks read the same bytes.
- **Read stage**: R worker threads materialize sources: local paths
  pass through, cloud URLs (gs://, s3:// via ``cloud_io``) fetch into
  the atomic cache, ``(url, start, length)`` tuples become range reads.
  Transient read failures retry under the bounded-backoff policy
  (``resilience/service.backoff_delay``).
- **Decode stage**: D worker threads parse payloads into ``DataSet``
  minibatches, the native C++ IDX/CSV parsers first
  (``datasets/native_io``), a byte-identical Python parse otherwise.
- **Reorder**: decoded batches are put back into SOURCE ORDER before
  emission, so the pipeline's batch stream is deterministic and a fit
  through it reproduces the sync iterator's loss trajectory exactly.
- **Device stage**: a thread of its own stages each batch on the card
  through ``datasets/iterator.DeviceStager`` (the host cast, pinned
  memory, a non-blocking copy on the thread's own CUDA stream, an event
  the consumer's stream waits on), so the copy of batch N+1 overlaps
  the step of batch N. Bound to a mesh (``attach(mesh=...)``, as the
  trainers do), a batch lands as this data rank's rows, marked
  ``data_ranks = mesh.n_data`` so that ``ParallelTrainer`` cuts no rows
  again: a pipeline sharded by data index already reads local batches;
  one that reads global batches (``num_shards=1``) cuts this rank's rows
  of each of the trainer's microbatches on the host, before the copy, so
  only those rows cross PCIe.
  ``place=False`` keeps batches on the host.

Every stage runs inside span-tracer spans (``input:read`` /
``input:decode`` / ``input:h2d`` / ``input:wait``), so a hang's
open-span stack names the input stage, and the ``input_*`` counters and
gauge land in the metrics registry. The time a consumer blocks in
``next()`` is the pipeline's **input stall**: accumulated here
(``stall_s``, ``input_stall_seconds_total``), and seen by
``TrainingStats.export()``'s ``input_stall_s`` around every ``next()``.

Chaos seams (``resilience/faultinject``): ``slow_input`` stalls the Nth
``next()`` (the stall lands in ``input_stall_s`` and the open-span
stack names ``input:wait``); ``io_error`` raises on the Nth reader read
(the retry policy must absorb it, counted in
``input_read_retries_total``).

**Windowed shuffle**: pure source order is bad for convergence on
sorted corpora, but an unbounded shuffle cannot be resumed.
``shuffle_window=W`` applies a deterministic bounded-buffer shuffle to
the SHARDED source order (the buffer holds at most ``W`` sources, and no
source is emitted more than ``W - 1`` positions early), seeded by
``shuffle_seed`` and the epoch counter: the emission order is a pure
function of ``(seed, epoch, shard)``, never of decode timing. That is
what makes a shuffled stream resumable: ``cursor_state()`` captures
``{seed, window, epoch, emitted}``, and a fresh pipeline with
``restore_cursor(state)`` replays the same emission order and skips the
consumed prefix: the resumed tail is bitwise the unbroken run's, with no
batch dropped, doubled or re-randomized. ``shuffle_signature()`` is the
shuffle identity a resumable trainer records beside its data position.
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
import queue
import random
import struct
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    DataSetIterator, DeviceStager,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.profiling.watchdog import beat as watchdog_beat

__all__ = [
    "StreamingInputPipeline", "IdxPair", "shard_sources", "read_idx",
    "windowed_shuffle_order",
]

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# source sharding
# ---------------------------------------------------------------------------

def shard_sources(sources: Sequence, num_shards: Optional[int] = None,
                  shard_index: Optional[int] = None) -> List:
    """Disjoint strided shard of a source list: shard k of n takes
    ``sources[k::n]``. Defaults come from ``multihost``
    (``process_count()`` / ``process_index()``), so every process reads
    a disjoint slice of the dataset (``multihost.shard_sources`` shards
    by data index on a mesh); strided, not contiguous, so size-ordered
    file lists stay balanced across ranks. Uneven shards warn: every
    rank must run the same number of steps, and a rank whose shard runs
    dry first leaves its peers waiting inside a collective."""
    if num_shards is None or shard_index is None:
        from deeplearning4j_tpu_torch.parallel import multihost
        num_shards = multihost.process_count()
        shard_index = multihost.process_index()
    if num_shards < 1 or not (0 <= shard_index < num_shards):
        raise ValueError(
            f"bad shard spec: shard_index={shard_index} of "
            f"num_shards={num_shards}")
    sources = list(sources)
    if num_shards > 1 and len(sources) % num_shards != 0:
        logger.warning(
            "sharding %d sources across %d shards leaves them UNEVEN "
            "(%d vs %d): under data-parallel training every rank must run "
            "the same number of steps, so a rank whose shard runs dry "
            "first deadlocks the others inside the step's collectives — "
            "pad or trim the source list to a multiple of the shard count "
            "(and keep sources equal-sized)",
            len(sources), num_shards, -(-len(sources) // num_shards),
            len(sources) // num_shards)
    return sources[shard_index::num_shards]


# ---------------------------------------------------------------------------
# windowed shuffle (bounded, deterministic, resumable)
# ---------------------------------------------------------------------------

def windowed_shuffle_order(n: int, window: int, rng) -> List[int]:
    """Deterministic bounded-buffer shuffle of ``range(n)``: stream the
    indices through a buffer of at most ``window`` entries, emitting a
    random buffer member each time the buffer fills (then draining it).
    The buffer bound is what makes the shuffle streamable: no element
    is emitted more than ``window - 1`` positions EARLY (it cannot
    enter the buffer before its source position), so readers never need
    to run further than ``window`` ahead of emission. The output is a
    pure function of ``(n, window, rng state)``: replaying with the
    same seeded ``rng`` reproduces the order exactly (the resumability
    contract). ``window <= 1`` is the identity (shuffle off)."""
    if window <= 1 or n <= 1:
        return list(range(n))
    order: List[int] = []
    buf: List[int] = []
    for i in range(n):
        buf.append(i)
        if len(buf) >= min(window, n):
            order.append(buf.pop(int(rng.integers(len(buf)))))
    while buf:
        order.append(buf.pop(int(rng.integers(len(buf)))))
    return order


# ---------------------------------------------------------------------------
# decoding helpers (native fast path + Python fallback)
# ---------------------------------------------------------------------------

@dataclass
class IdxPair:
    """An (images, labels) pair of IDX files (MNIST-shaped) as one
    pipeline source. Local paths decode through the native C++ parser
    when the shared library is built, Python otherwise: byte-for-byte
    the same output. Cloud URLs are fetched into the atomic cache by the read stage
    first, then decoded from the local file."""

    images: str
    labels: str
    scale: float = 1.0 / 255.0
    num_classes: Optional[int] = None   # one-hot the labels when set
    add_channel_dim: bool = False       # [N,H,W] -> [N,H,W,1]


def _idx_read_u8(path: Union[str, Path]) -> np.ndarray:
    """Validated IDX (u8 payload) parse returning the raw uint8 array
    (a zero-copy ``frombuffer`` view of the file bytes)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        data = f.read()
    if len(data) < 4 or data[:2] != b"\x00\x00" or data[2] != 0x08:
        # same gate as the C parser (header[0..1]==0, dtype==0x08): a
        # non-u8 IDX payload reinterpreted byte-by-byte would train
        # silently on shredded values
        raise ValueError(
            f"{path}: not an unsigned-byte IDX file "
            f"(magic {data[:4]!r}) — only u8 IDX payloads are supported")
    ndim = data[3]
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def _idx_read_python(path: Union[str, Path], scale: float) -> np.ndarray:
    """Pure-Python IDX (u8 payload) parser — the fallback the native
    fast path must match bitwise: f32(f64(byte) * f64(scale)), the
    exact double-product-then-cast the C parser computes
    (``(float)(buf[i] * scale)``) — a single-precision product would
    differ by 1 ulp on ~half the byte values."""
    return (_idx_read_u8(path).astype(np.float64)
            * float(scale)).astype(np.float32)


def read_idx(path: Union[str, Path],
             scale: Optional[float] = 1.0) -> np.ndarray:
    """IDX file -> float32 array scaled by ``scale``: the native C++
    fast path (``native_io.idx_read``) when available and the file is
    plain IDX, else the Python parser. The two paths agree bitwise.

    ``scale=None`` returns the raw uint8 payload instead — there is
    nothing to compute, so it is always the zero-copy Python parse
    (no float64/float32 intermediates, no native round trip)."""
    if scale is None:
        return _idx_read_u8(path)
    from deeplearning4j_tpu_torch.datasets import native_io
    out = native_io.idx_read(path, scale=scale)
    if out is None:
        out = _idx_read_python(path, scale)
    return out


def _decode_idx_pair(pair: IdxPair, images_path, labels_path,
                     batch_size: Optional[int]) -> List[DataSet]:
    feats = read_idx(images_path, scale=pair.scale)
    labels = read_idx(labels_path, scale=1.0)
    if pair.add_channel_dim:
        feats = feats[..., None]
    if pair.num_classes:
        labels = np.eye(pair.num_classes,
                        dtype=np.float32)[labels.astype(np.int64)]
    ds = DataSet(feats, labels)
    return ds.batch_by(batch_size) if batch_size else [ds]


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

_END = object()


class _Generation:
    """One ``_start()``'s worth of worker-shared state. Every worker
    thread holds a reference to ITS generation, so a straggler that
    outlives a ``reset()`` (the shutdown join times out while it is
    stuck in a long read) can only ever touch its own dead generation's
    queues, event and counters — never the restarted run's. Without
    this, a stale reader waking after reset would decrement the new
    ``readers_live``, poison the new decode pool early, and hang the
    consumer on a source index nobody will ever post."""

    def __init__(self, sources: List, queue_size: int, device_buffer: int,
                 readers: int):
        self.sources = sources
        self.stop = threading.Event()
        self.read_q: "queue.Queue" = queue.Queue()
        for i, src in enumerate(sources):
            self.read_q.put((i, src))
        self.decode_q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.out_q: "queue.Queue" = queue.Queue(maxsize=device_buffer)
        # reorder buffer: source index -> ("data", [DataSet]) | ("error", e)
        self.ready: dict = {}
        self.ready_cv = threading.Condition()
        self.next_emit = 0   # emission cursor (readers gate on it)
        self.readers_live = readers


class StreamingInputPipeline(DataSetIterator):
    """Sharded, staged, order-preserving input pipeline (module
    docstring has the stage diagram).

    ``sources`` entries may be: a ``DataSet`` (sliced to
    ``batch_size``), a ``MultiDataSet`` (emitted whole — pre-slice
    multi-input data; ``batch_size`` with a ``MultiDataSet`` source is
    rejected at construction rather than silently ignored), a callable
    returning either (synthesized data — runs in the decode pool), an
    :class:`IdxPair`, or — with a ``decode_fn`` — a path/URL string or
    ``(url, start, length)`` byte range whose raw payload
    ``decode_fn(payload, source)`` turns into a ``DataSet`` or list of
    them.

    ``num_shards``/``shard_index`` take a disjoint strided shard of the
    source list (default, resolved once at the first iteration: the
    bound mesh's data axis, ``mesh.n_data`` / ``mesh.data_index``, else
    the ``multihost`` process grid). ``attach(mesh=...)``, called by the
    trainers, binds the device stage to a ``MeshContext``: every batch
    lands on the mesh's device as this data rank's rows, marked
    ``data_ranks = mesh.n_data`` (a global batch, ``num_shards=1``, is
    cut to the rank's rows of each of the trainer's microbatches on the
    host first). Without a mesh, batches are staged on ``device``
    (``None``: the card, raising without one; ``"cpu"``: host tensors). ``dtype`` casts features and labels on the
    host before the copy. ``place=False`` (or ``attach(place=False)``,
    ``ParallelWrapper``'s path) keeps batches on the host as numpy.

    The emitted batch ORDER is the sharded source order: a fit through
    the pipeline is trajectory-identical to the same batches through a
    sync iterator (``chip_smoke.py``'s ``input_path`` phase gates this
    on the card).
    ``shuffle_window=W > 1`` replaces source order with a deterministic
    windowed shuffle of it (seeded by ``shuffle_seed`` + the epoch
    counter; a ``W``-entry buffer, so no source is emitted more than
    ``W - 1`` early) that stays cursor-resumable: ``cursor_state()`` /
    ``restore_cursor()`` replay the exact emission order across a
    crash or elastic resize, consumed prefix skipped — see the module
    docstring.
    """

    def __init__(self, sources: Sequence, *,
                 batch_size: Optional[int] = None,
                 decode_fn: Optional[Callable] = None,
                 reader_workers: int = 2, decode_workers: int = 2,
                 queue_size: int = 4, device_buffer: int = 2,
                 num_shards: Optional[int] = None,
                 shard_index: Optional[int] = None,
                 mesh=None, dtype: Optional[str] = None,
                 place: bool = True, device=None,
                 read_retries: int = 3, retry_base_s: float = 0.05,
                 retry_max_s: float = 1.0, cache_dir: Optional[str] = None,
                 reorder_window: Optional[int] = None,
                 shuffle_window: int = 0, shuffle_seed: int = 0):
        if (num_shards is None) != (shard_index is None):
            raise ValueError("pass num_shards and shard_index together "
                             "(or neither, for the multihost defaults)")
        self._all_sources = list(sources)
        self._batch_size = batch_size
        self._decode_fn = decode_fn
        self._readers = max(1, int(reader_workers))
        self._decoders = max(1, int(decode_workers))
        self._queue_size = max(1, int(queue_size))
        self._device_buffer = max(1, int(device_buffer))
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._mesh = mesh
        self._microbatches = 1
        self._dtype = dtype
        self._place = place
        self._device = device
        self._stager: Optional[DeviceStager] = None
        self._read_retries = max(0, int(read_retries))
        self._retry_base_s = retry_base_s
        self._retry_max_s = retry_max_s
        self._cache_dir = cache_dir
        # how many sources past the emission cursor readers may run
        # ahead: bounds the reorder buffer (without it, one slow early
        # source lets the pool decode ~the whole dataset into host RAM)
        self._window = max(2, int(reorder_window) if reorder_window
                           else self._readers + self._decoders
                           + self._queue_size)
        self._rng = random.Random(0x1D4)
        self._shuffle_window = max(0, int(shuffle_window))
        self._shuffle_seed = int(shuffle_seed)
        for src in self._all_sources:
            self._check_source(src)
        self.stall_s = 0.0          # consumer time blocked in next()
        self.batches_emitted = 0
        self.samples_emitted = 0
        self._started = False
        self._peek = None
        self._done = False
        self._closed = False
        # shuffle epoch/position bookkeeping (the resumable-RNG cursor):
        # _epochs_started seeds the NEXT generation's shuffle order;
        # _gen_epoch/_gen_emitted describe the current one; _resume_skip
        # is the restored cursor's already-consumed prefix, drained
        # silently on the next start
        self._epochs_started = 0
        self._gen_epoch = 0
        self._gen_emitted = 0
        self._resume_skip = 0
        self._skip_left = 0
        self._closed_state: Optional[dict] = None

    # ------------------------------------------------------------- contract
    @property
    def places_sharded(self) -> bool:
        """True when emitted batches land on a mesh's device as this data
        rank's rows (graphcheck GC013 reads this)."""
        return self._place and self._mesh is not None

    def async_supported(self) -> bool:
        return False    # already async — wrapping would double-thread

    def attach(self, mesh=None, dtype: Optional[str] = None,
               place: Optional[bool] = None,
               microbatches: Optional[int] = None
               ) -> "StreamingInputPipeline":
        """Bind the device stage to a trainer's mesh/dtype. Trainers
        call this from ``fit``; a mesh set at construction wins, and the
        binding is frozen once iteration has started (the batches' layout
        must not change mid-epoch). ``microbatches`` (the port's, passed
        by the trainers: their gradient accumulation or pipeline
        microbatches) is how a global batch (``num_shards=1``) is cut:
        this rank's rows of each microbatch (``MeshContext.rank_rows``)."""
        if self._started:
            return self
        if mesh is not None and self._mesh is None:
            self._mesh = mesh
        if dtype is not None and self._dtype is None:
            self._dtype = dtype
        if place is not None:
            self._place = place
        if microbatches is not None:
            self._microbatches = max(1, int(microbatches))
        self._stager = None     # made anew for the binding at the start
        return self

    # ----------------------------------------------------- shuffle cursor
    def shuffle_signature(self) -> Optional[dict]:
        """The shuffle identity a resumable trainer records next to its
        data position (``TrainingCursor.extra["input"]``): resuming
        against a pipeline with a DIFFERENT signature would replay the
        cursor tail over a re-randomized order, so trainers reject the
        mismatch up front. None when shuffling is off."""
        if self._shuffle_window <= 1:
            return None
        return {"kind": "windowed_shuffle", "seed": self._shuffle_seed,
                "window": self._shuffle_window}

    def cursor_state(self) -> dict:
        """Where the shuffled stream stands: the RNG identity (seed +
        window — the order is a pure function of them and the epoch)
        plus the window cursor (epoch, batches emitted this epoch).
        Hand this to a fresh pipeline's ``restore_cursor`` to resume
        the exact emission order, consumed-prefix excluded."""
        if self._started:
            return {"shuffle_seed": self._shuffle_seed,
                    "shuffle_window": self._shuffle_window,
                    "epoch": self._gen_epoch,
                    "emitted": self._gen_emitted + self._skip_left}
        if self._closed_state is not None:
            # shut down mid-epoch (close()): where consumption stood
            return dict(self._closed_state)
        return {"shuffle_seed": self._shuffle_seed,
                "shuffle_window": self._shuffle_window,
                "epoch": self._epochs_started,
                "emitted": self._resume_skip}

    def restore_cursor(self, state: dict) -> "StreamingInputPipeline":
        """Resume a shuffled stream exactly: the next iteration replays
        epoch ``state["epoch"]``'s emission order and silently drops
        the first ``state["emitted"]`` batches (they were consumed
        before the crash/resize). The pipeline must be constructed with
        the SAME ``shuffle_seed``/``shuffle_window`` the state records
        — anything else would re-randomize the tail, so it raises."""
        want = {"shuffle_seed": self._shuffle_seed,
                "shuffle_window": self._shuffle_window}
        got = {k: state.get(k) for k in want}
        if got != want:
            raise ValueError(
                f"cursor records shuffle state {got} but this pipeline "
                f"was built with {want}: resuming would replay the "
                "tail over a different emission order — construct the "
                "pipeline with the recorded seed/window")
        if self._started:
            raise RuntimeError(
                "restore_cursor() must run before iteration starts "
                "(construct a fresh pipeline, restore, then iterate)")
        self._epochs_started = int(state.get("epoch", 0))
        self._resume_skip = max(0, int(state.get("emitted", 0)))
        return self

    def _check_source(self, src) -> None:
        if isinstance(src, MultiDataSet) and self._batch_size:
            raise ValueError(
                "batch_size slicing is not supported for MultiDataSet "
                "sources (MultiDataSet has no batch_by) — pre-slice "
                "multi-input data into per-batch MultiDataSets")
        if isinstance(src, (DataSet, MultiDataSet, IdxPair)) \
                or callable(src):
            return
        if isinstance(src, (str, Path)) or (
                isinstance(src, tuple) and len(src) == 3
                and isinstance(src[0], str)):
            if self._decode_fn is None:
                raise ValueError(
                    f"source {src!r} is a raw path/URL/byte-range — pass "
                    "decode_fn=(payload, source) -> DataSet(s) (or use "
                    "IdxPair for IDX image/label pairs)")
            return
        raise TypeError(f"unsupported source type {type(src).__name__}")

    # ------------------------------------------------------------ lifecycle
    def _start(self) -> None:
        if self.num_shards is None:
            # resolve the defaults ONCE (so a later reset keeps the same
            # shard): the bound mesh's data axis, else the process grid
            if self._mesh is not None:
                self.num_shards = self._mesh.n_data
                self.shard_index = self._mesh.data_index
            else:
                from deeplearning4j_tpu_torch.parallel import multihost
                self.num_shards = multihost.process_count()
                self.shard_index = multihost.process_index()
        mesh = self._mesh
        if mesh is not None and self.num_shards > 1 and (
                self.num_shards, self.shard_index) != (mesh.n_data,
                                                       mesh.data_index):
            # the ranks of one replica (its model, sp and pp ranks) must
            # read the same rows: a shard by process would split them
            raise ValueError(
                f"the pipeline reads shard {self.shard_index} of "
                f"{self.num_shards}, but the mesh's data rank is "
                f"{mesh.data_index} of {mesh.n_data}: shard by the mesh's "
                "data axis (num_shards=mesh.n_data, shard_index="
                "mesh.data_index, as multihost.input_pipeline(sources, mesh) "
                "does) or read global batches (num_shards=1)")
        if self._place and self._stager is None:
            # on the consumer's thread, so that a missing card raises here
            if self._mesh is not None:
                device = self._mesh.device
            else:
                from deeplearning4j_tpu_torch.device import resolve_device
                device = resolve_device(self._device)
            self._stager = DeviceStager(device, self._dtype)
        shard = shard_sources(self._all_sources, self.num_shards,
                              self.shard_index)
        epoch = self._epochs_started
        self._epochs_started += 1
        self._gen_epoch = epoch
        self._gen_emitted = 0
        self._closed_state = None
        skip = self._resume_skip
        self._resume_skip = 0
        if self._shuffle_window > 1:
            # emission order = windowed shuffle of the SHARDED source
            # order, a pure function of (seed, epoch) — permuting the
            # source list up front reuses the whole in-order reorder
            # machinery unchanged, and keeps the order independent of
            # decode timing (the resumability contract)
            order = windowed_shuffle_order(
                len(shard), self._shuffle_window,
                np.random.default_rng([self._shuffle_seed, epoch]))
            shard = [shard[i] for i in order]
        if skip and self._batch_size is None and all(
                isinstance(s, (DataSet, MultiDataSet)) for s in shard):
            # resume SEEK fast path: when every source is provably one
            # batch (in-memory DataSets, no batch_size splitting),
            # emission order == the (permuted) list order, so the
            # consumed prefix is dropped by slicing — O(tail) resume
            # instead of re-reading/decoding/staging the prefix just
            # to discard it. Other source shapes (batch_by splits,
            # decode_fn lists) fall back to the consumer-side drain.
            drop = min(skip, len(shard))
            shard = shard[drop:]
            self._gen_emitted = drop
            skip -= drop
        self._skip_left = skip
        gen = self._gen = _Generation(
            shard,
            self._queue_size, self._device_buffer, self._readers)
        self._threads: List[threading.Thread] = []
        for k in range(self._readers):
            t = threading.Thread(target=self._read_worker, args=(gen,),
                                 name=f"input-read-{k}", daemon=True)
            t.start()
            self._threads.append(t)
        for k in range(self._decoders):
            t = threading.Thread(target=self._decode_worker, args=(gen,),
                                 name=f"input-decode-{k}", daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._device_worker, args=(gen,),
                             name="input-h2d", daemon=True)
        t.start()
        self._threads.append(t)
        self._started = True
        self._peek = None
        self._done = False

    def _shutdown(self) -> None:
        if not self._started:
            return
        # freeze the cursor BEFORE tearing the generation down:
        # cursor_state() after close() must describe the INTERRUPTED
        # epoch (where consumption stood), not silently roll over to
        # the next epoch at position 0 — that would lose the epoch's
        # unconsumed tail on resume with no error
        self._closed_state = {"shuffle_seed": self._shuffle_seed,
                              "shuffle_window": self._shuffle_window,
                              "epoch": self._gen_epoch,
                              "emitted": self._gen_emitted
                              + self._skip_left}
        gen = self._gen
        gen.stop.set()
        with gen.ready_cv:
            gen.ready_cv.notify_all()
        # unblock producers parked on full queues
        for q in (gen.decode_q, gen.out_q):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        # wake a consumer blocked in next() on this generation's out_q
        # (close() from a supervising thread must not leave the trainer
        # thread hung in an untimed Queue.get forever). Workers are
        # joined/stopped, so nothing else posts: if the queue is full a
        # blocked consumer already has an item to wake on.
        try:
            gen.out_q.put_nowait(("end", None))
        except queue.Full:
            pass
        self._threads = []
        self._started = False

    def close(self) -> None:
        """Stop the worker threads and END the stream: a consumer mid-fit
        sees StopIteration on its next ``next()`` rather than a silently
        restarted pipeline re-emitting batch 0 (``_ensure`` re-starts
        whenever ``_started`` is unset — only ``reset()`` may do that)."""
        self._closed = True
        self._shutdown()

    def reset(self) -> None:
        self._closed = False
        self._shutdown()
        self._start()

    # --------------------------------------------------------------- stages
    @staticmethod
    def _halt(gen: _Generation) -> None:
        """Stop the worker pool once the stream has ended (all batches
        emitted, or an in-order error already posted): readers and
        decoders must not keep fetching sources nobody will drain —
        wasted I/O plus an unbounded reorder buffer. The already-posted
        out_q items are untouched; only the consumer drains that queue."""
        gen.stop.set()
        with gen.ready_cv:
            gen.ready_cv.notify_all()

    @staticmethod
    def _put(gen: _Generation, q: "queue.Queue", item) -> bool:
        """Bounded put that aborts on shutdown instead of deadlocking."""
        while not gen.stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _metrics(self):
        return get_registry()

    def _read_source(self, src):
        """Materialize one source (runs in a reader worker): local paths
        pass through, cloud URLs land in the atomic cache, byte ranges
        become ``cloud_io`` range reads. The faultinject ``io_error``
        hook fires per ATTEMPT, so the retry loop around this call is
        what a flaky object store actually exercises."""
        from deeplearning4j_tpu_torch.datasets import cloud_io
        from deeplearning4j_tpu_torch.resilience import faultinject
        faultinject.on_reader_read(src)
        if isinstance(src, (DataSet, MultiDataSet)) or callable(src):
            return src
        if isinstance(src, IdxPair):
            def local(p):
                return (cloud_io.fetch_to_cache(p, cache_dir=self._cache_dir)
                        if cloud_io.is_cloud_url(p) else Path(p))
            return (src, local(src.images), local(src.labels))
        if isinstance(src, tuple):        # (url, start, length) range read
            url, start, length = src
            return cloud_io.read_url(url, start=start, length=length)
        src = str(src)
        if cloud_io.is_cloud_url(src):
            return cloud_io.fetch_to_cache(src, cache_dir=self._cache_dir)
        return Path(src)

    def _read_worker(self, gen: _Generation) -> None:
        tracer = get_tracer()
        reg = self._metrics()
        from deeplearning4j_tpu_torch.resilience.service import (
            backoff_delay,
        )
        while not gen.stop.is_set():
            try:
                i, src = gen.read_q.get_nowait()
            except queue.Empty:
                break
            # run-ahead gate: don't start source i until emission is
            # within _window of it. read_q is index-ordered, so every
            # smaller index is already read/decoding and the sequencer
            # always has progress to make — bounded buffer, no
            # starvation.
            with gen.ready_cv:
                while (not gen.stop.is_set()
                       and i - gen.next_emit >= self._window):
                    gen.ready_cv.wait(timeout=0.1)
            if gen.stop.is_set():
                break
            t0 = time.perf_counter()
            try:
                with tracer.span("input:read", source=i):
                    attempt = 0
                    while True:
                        try:
                            raw = self._read_source(src)
                            break
                        except Exception:
                            attempt += 1
                            if attempt > self._read_retries \
                                    or gen.stop.is_set():
                                raise
                            reg.counter(
                                "input_read_retries_total",
                                help="reader-worker read attempts retried "
                                     "under the bounded-backoff policy"
                            ).inc()
                            time.sleep(backoff_delay(
                                attempt, self._retry_base_s,
                                self._retry_max_s, self._rng))
                reg.counter("input_read_seconds_total",
                            help="wall seconds in the pipeline read stage"
                            ).inc(time.perf_counter() - t0)
                self._put(gen, gen.decode_q, (i, raw))
            except BaseException as e:  # noqa: BLE001 — surfaced in order
                self._post(gen, i, ("error", e))
        with gen.ready_cv:
            gen.readers_live -= 1
            last = gen.readers_live == 0
        if last:
            # all sources read: poison the decode pool. OUTSIDE the
            # condition lock — a full decode queue would otherwise hold
            # the lock the decoders need (to post results) to drain it
            for _ in range(self._decoders):
                self._put(gen, gen.decode_q, _END)

    def _decode(self, raw, src) -> List[DataSet]:
        if isinstance(raw, tuple) and raw and isinstance(raw[0], IdxPair):
            pair, imgs, labels = raw
            return _decode_idx_pair(pair, imgs, labels, self._batch_size)
        if callable(raw):
            raw = raw()
        if isinstance(raw, (DataSet, MultiDataSet)):
            if self._batch_size and isinstance(raw, DataSet):
                return raw.batch_by(self._batch_size)
            return [raw]
        if isinstance(raw, (list, tuple)) \
                and all(isinstance(b, (DataSet, MultiDataSet)) for b in raw):
            return list(raw)
        if self._decode_fn is not None:
            out = self._decode_fn(raw, src)
            return list(out) if isinstance(out, (list, tuple)) else [out]
        raise TypeError(
            f"cannot decode payload of type {type(raw).__name__} "
            "without a decode_fn")

    def _decode_worker(self, gen: _Generation) -> None:
        tracer = get_tracer()
        reg = self._metrics()
        while not gen.stop.is_set():
            try:
                item = gen.decode_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _END:
                break
            i, raw = item
            t0 = time.perf_counter()
            try:
                with tracer.span("input:decode", source=i):
                    batches = self._decode(raw, gen.sources[i])
                reg.counter("input_decode_seconds_total",
                            help="wall seconds in the pipeline decode stage"
                            ).inc(time.perf_counter() - t0)
                self._post(gen, i, ("data", batches))
            except BaseException as e:  # noqa: BLE001 — surfaced in order
                self._post(gen, i, ("error", e))

    @staticmethod
    def _post(gen: _Generation, i: int, result) -> None:
        with gen.ready_cv:
            gen.ready[i] = result
            gen.ready_cv.notify_all()

    def _local_rows(self, ds):
        """``ds`` as this data rank's rows of the bound mesh, marked
        ``data_ranks``: a batch of a pipeline sharded by data index (the
        shard checked against the mesh at the start) is one already; a
        global batch (``num_shards=1``) is cut here, on the host, to the
        rank's rows of each of the trainer's microbatches. A mesh with
        one data index keeps the batch as it is."""
        from deeplearning4j_tpu_torch.parallel.mesh import take_rows
        mesh = self._mesh
        n = mesh.n_data
        if n == 1 or ds.data_ranks is not None:
            return ds
        if self.num_shards == 1:
            ds = take_rows(ds, mesh.rank_rows(ds.num_examples(),
                                              self._microbatches))
        return dataclasses.replace(ds, data_ranks=n)

    def _stage_batch(self, ds):
        """Host cut, cast and copy of one batch onto the card (the double
        buffer's producer side): ``(batch, copy event or None)``. With a
        mesh the batch becomes this data rank's rows first (host batches
        too), so the trainer cuts no rows again and only those rows cross
        PCIe."""
        if self._mesh is not None:
            ds = self._local_rows(ds)
        if not self._place:
            return ds, None
        return self._stager.stage(ds)

    def _device_worker(self, gen: _Generation) -> None:
        """Sequencer + device stage: drain the reorder buffer in source
        order, place each batch, double-buffer into the output queue."""
        tracer = get_tracer()
        reg = self._metrics()
        nxt = 0
        while not gen.stop.is_set():
            if nxt >= len(gen.sources):
                self._put(gen, gen.out_q, ("end", None))
                self._halt(gen)
                return
            with gen.ready_cv:
                while nxt not in gen.ready and not gen.stop.is_set():
                    gen.ready_cv.wait(timeout=0.1)
                if gen.stop.is_set():
                    return
                tag, payload = gen.ready.pop(nxt)
                nxt += 1
                gen.next_emit = nxt     # release gated readers
                gen.ready_cv.notify_all()
            if tag == "error":
                self._put(gen, gen.out_q, ("error", payload))
                self._halt(gen)
                return  # in-order error ends the stream (async contract)
            for ds in payload:
                t0 = time.perf_counter()
                try:
                    with tracer.span("input:h2d"):
                        staged = self._stage_batch(ds)
                except BaseException as e:  # noqa: BLE001
                    self._put(gen, gen.out_q, ("error", e))
                    self._halt(gen)
                    return
                reg.counter("input_h2d_seconds_total",
                            help="wall seconds staging batches on device"
                            ).inc(time.perf_counter() - t0)
                if not self._put(gen, gen.out_q, ("data", staged)):
                    return

    # ------------------------------------------------------------- consumer
    def _ensure(self) -> None:
        if not self._started:
            self._start()
        if self._peek is not None or self._done:
            return
        from deeplearning4j_tpu_torch.resilience import faultinject
        tracer = get_tracer()
        reg = self._metrics()
        t0 = time.perf_counter()
        # the stall is measured AND attributed: while the consumer is
        # blocked here the open-span stack names input:wait — a starved
        # trainer diagnoses as input-bound, not as a mystery hang
        # last beat BEFORE the blocking get(): a starved consumer goes
        # stale with input:wait as its deepest open span
        watchdog_beat("input_pipeline")
        with tracer.span("input:wait"):
            stall = faultinject.on_input_next()
            if stall > 0.0:
                time.sleep(stall)
            item = self._gen.out_q.get()
            # resumed-cursor replay: the already-consumed prefix of the
            # (re-derived, identical) emission order is dropped silently
            # so the consumer sees exactly the unconsumed tail
            while self._skip_left > 0 and item[0] == "data":
                self._skip_left -= 1
                self._gen_emitted += 1
                item = self._gen.out_q.get()
            self._peek = item
        waited = time.perf_counter() - t0
        self.stall_s += waited
        reg.counter("input_stall_seconds_total",
                    help="consumer seconds blocked waiting on the input "
                         "pipeline (the card-starvation measure)"
                    ).inc(waited)
        reg.gauge("input_queue_depth",
                  help="staged batches ready in the pipeline output queue"
                  ).set(self._gen.out_q.qsize())

    def has_next(self) -> bool:
        if self._done or self._closed:
            return False
        self._ensure()
        tag, payload = self._peek
        if tag == "error":
            self._done = True
            raise payload
        return tag == "data"

    def next(self) -> DataSet:
        if self._done or self._closed:
            raise StopIteration
        self._ensure()
        tag, payload = self._peek
        if tag == "data":
            self._peek = None
            payload = self._ready(payload)
            self.batches_emitted += 1
            self._gen_emitted += 1
            self.samples_emitted += payload.num_examples()
            reg = self._metrics()
            reg.counter("input_batches_total",
                        help="batches emitted by the input pipeline").inc()
            reg.counter("input_samples_total",
                        help="samples emitted by the input pipeline"
                        ).inc(payload.num_examples())
            return payload
        self._done = True
        if tag == "error":
            raise payload
        raise StopIteration

    def _ready(self, item):
        """The staged batch, safe to read on the consumer's stream."""
        return item[0] if self._stager is None else self._stager.ready(item)

    def batch_size(self) -> int:
        return self._batch_size or 0
