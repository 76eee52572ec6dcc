"""Data-parallel embedding training over a ``torch.distributed`` group (the
JAX package's ``nlp/distributed.py``).

Ref: the reference scales Word2Vec two ways — Spark-side per-partition
training with accumulator-merged vectors (dl4j-spark-nlp/.../word2vec/
Word2Vec.java + Word2VecPerformer.java) and the java8 SparkSequenceVectors
that shards sequences across executors (dl4j-spark-nlp-java8/.../
SparkSequenceVectors.java).

The JAX package replicates the tables over a ``data`` mesh axis, shards
every batch over it and lets GSPMD run the single-device step as one
program: its semantics are the single-device step on the whole batch,
trimmed to a multiple of the device count. Here one process is one rank
of a process group (``group=None``: the default group; the JAX
package's ``devices=``), and every rank holds the whole tables:

- every rank draws the same host stream from the seed, so the pairs,
  the negatives, the permutation and the trim agree on every rank;
- rank r computes the gathers and products for its contiguous chunk of
  every batch (the rows ``P("data")`` gives device r);
- the steps scale each touched row's summed update by 1/count**power,
  with counts over the whole batch, so before that scale each rank's
  (rows, sums, counts) are combined across the ranks (``_combine``, the
  steps' ``combine`` hook): every rank gathers the others' touched rows,
  padded to the most any rank touched, with their sums and counts (not
  the dense tables), and sums each row's entries in rank order. Every
  rank then applies the same update, the single-process step's on the
  trimmed batch up to the order of the sums, and the ranks' tables stay
  bit for bit equal after every step.

The collectives are ``parallel/mesh.py``'s (gloo stages CUDA tensors
through host memory). At world 1 the trainer is ``SequenceVectors``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nlp.sequencevectors import (SequenceVectors,
                                                          _row_sums)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.parallel.mesh import MeshContext


class SparkSequenceVectors(SequenceVectors):
    """SequenceVectors data-parallel over a process group. The name mirrors
    the reference class it replaces (SparkSequenceVectors.java); "Spark"
    here means the scale-out tier — the executor fleet is the group's
    ranks, one device a rank (``device`` as ``SequenceVectors``')."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._mesh = MeshContext.create(device=self.device, group=group)
        self._n_dev = self._mesh.world

    def _put_batch(self, arr) -> torch.Tensor:
        """This rank's contiguous chunk of a batch, on its device."""
        arr = np.asarray(arr)
        return super()._put_batch(arr[self._mesh.batch_slice(len(arr))])

    def _adjust_selection(self, sel: np.ndarray) -> np.ndarray:
        """Trim to a multiple of the rank count (SGD over a pair stream
        loses nothing by dropping < n_dev trailing pairs; the reference's
        Spark split sizing rounds the same way)."""
        keep = (len(sel) // self._n_dev) * self._n_dev
        return sel[:keep]

    def _step_kwargs(self) -> dict:
        return {"combine": self._combine} if self._n_dev > 1 else {}

    def _combine(self, rows, sums, cnt, n_rows: int):
        """The whole batch's (rows, sums, counts) from each rank's: the
        ranks' touched rows gathered (padded with the row ``n_rows``,
        which no table holds, to the most any rank touched), and each
        row's sums and counts added in rank order (``_row_sums``' stable
        sort keeps the gather's order). One gather a table: each int64
        row index rides beside its sums and count as two float32 words
        of the same bits (a view, not a conversion)."""
        mesh = self._mesh
        width = torch.tensor([rows.numel()], device=rows.device)
        pad = int(mesh.all_reduce_(width, "max")) - rows.numel()
        vals = F.pad(torch.cat([sums, cnt[:, None]], dim=1), (0, 0, 0, pad))
        rows = F.pad(rows.to(torch.int64), (0, pad), value=n_rows)
        words = rows[:, None].view(vals.dtype)        # [R, 8 / itemsize]
        payload = torch.cat([words, vals], dim=1)
        gathered = mesh.all_gather(payload.reshape(-1)).view(
            -1, payload.shape[1])
        w = words.shape[1]
        all_rows = gathered[:, :w].contiguous().view(torch.int64)[:, 0]
        rows, total, cnt = _row_sums(all_rows, gathered[:, w:-1],
                                     gathered[:, -1])
        real = rows < n_rows
        return rows[real], total[real], cnt[real]


class SparkWord2Vec(Word2Vec, SparkSequenceVectors):
    """Word2Vec trained data-parallel over the group (ref: dl4j-spark-nlp
    Word2Vec.java entry point)."""
