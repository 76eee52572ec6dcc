"""ParagraphVectors (doc2vec): PV-DBOW and PV-DM.

Ref: deeplearning4j-nlp models/paragraphvectors/ParagraphVectors.java and
the sequence learning algorithms models/embeddings/learning/impl/sequence/
{DBOW,DM}.java. inferVector follows the reference's approach: freeze word
weights, gradient-descend a fresh doc vector.

Doc vectors live in their own [num_docs, D] matrix on the trainer's
device, trained by the same batched steps as words (DBOW = skip-gram
with the doc id as the "center"; DM = CBOW with the doc vector as one
more context slot).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors, _add_rows, _cbow_ns_core, _cbow_windows, _sgns_step)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, LabelsSource)


def _dm_step(dv, d, syn0, syn1neg, ctx, ctx_mask, centers, negs, lr):
    """One document's PV-DM update: CBOW-NS over the augmented table
    ``[dv[d]; syn0]``, the doc row in context slot 0 of every window, of
    which only the doc row's update is kept (the word rows' are thrown
    away, as the JAX package's ``_cbow_ns_step`` over the concatenated
    table does). The [V + 1, D] table is never built: the windows gather
    the doc row and the word rows apart. ``dv`` and ``syn1neg`` are
    updated in place; returns them."""
    B = ctx.shape[0]
    cvecs = torch.cat([dv[d].expand(B, 1, dv.shape[1]), syn0[ctx]], dim=1)
    mask = torch.cat([torch.ones(B, 1, dtype=ctx_mask.dtype,
                                 device=ctx_mask.device), ctx_mask], dim=1)
    dh, syn1neg = _cbow_ns_core(cvecs, mask, syn1neg, centers, negs, lr)
    # the doc row's count is the document's window count (slot 0 of each)
    rows = torch.tensor([d], device=dv.device)
    dv = _add_rows(dv, rows, dh.sum(dim=0, keepdim=True)
                   / torch.sqrt(torch.tensor(float(B), dtype=dh.dtype,
                                             device=dh.device)))
    return dv, syn1neg


class ParagraphVectors(SequenceVectors):
    def __init__(self, sequence_algo: str = "dbow",
                 tokenizer_factory: Optional[DefaultTokenizerFactory] = None,
                 train_words: bool = True, **kwargs):
        kwargs.setdefault("negative", 5)
        super().__init__(**kwargs)
        self.sequence_algo = sequence_algo.lower()
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.train_words = train_words
        self.labels_source = LabelsSource()
        self._label_index: Dict[str, int] = {}
        self.doc_vectors: Optional[np.ndarray] = None

    # -- fitting ------------------------------------------------------
    def fit_documents(self, documents: Sequence[str],
                      labels: Optional[Sequence[str]] = None) -> None:
        """documents: raw strings; labels default to DOC_i."""
        token_docs = [self.tokenizer_factory.create(d).get_tokens()
                      for d in documents]
        if labels is None:
            labels = [self.labels_source.next_label() for _ in documents]
        else:
            for l in labels:
                self.labels_source.store_label(l)
        self._label_index = {l: i for i, l in enumerate(labels)}

        if self.train_words or self.vocab is None:
            self.build_vocab(token_docs)
            super().fit(token_docs)  # word vectors first (as reference does)

        lt = self.lookup_table
        rng = np.random.default_rng(self.seed + 7)
        D = self.layer_size
        docs_idx = self._index_sequences(token_docs)
        dv = ((rng.random((len(labels), D)) - 0.5) / D).astype(np.float32)
        dvj = self._put_table(dv)
        syn1neg = self._put_table(lt.syn1neg)
        # PV-DM reads the word rows and never changes them
        syn0 = self._put_table(lt.syn0) if self.sequence_algo == "dm" \
            else None

        for epoch in range(max(1, self.epochs)):
            lr = max(self.min_learning_rate,
                     self.learning_rate * (1 - epoch / max(1, self.epochs)))
            if self.sequence_algo == "dm":
                # PV-DM: context words + doc vector -> center.
                for d, seq in enumerate(docs_idx):
                    if len(seq) < 2:
                        continue
                    ctx, mask, cents = _cbow_windows([seq], self.window)
                    negs = lt.sample_negatives(
                        rng, (len(cents), max(1, self.negative)))
                    dvj, syn1neg = _dm_step(
                        dvj, d, syn0, syn1neg, self._put_batch(ctx),
                        self._put_batch(mask), self._put_batch(cents),
                        self._put_batch(negs), lr)
            else:
                # PV-DBOW: doc id predicts each word in the doc (skip-gram
                # with center = doc vector row).
                cs, os_ = [], []
                for d, seq in enumerate(docs_idx):
                    cs.append(np.full(len(seq), d, np.int32))
                    os_.append(seq)
                cs = np.concatenate(cs) if cs else np.zeros(0, np.int32)
                os_ = np.concatenate(os_) if os_ else np.zeros(0, np.int32)
                order = rng.permutation(len(cs))
                for s in range(0, len(order), self.batch_size):
                    sel = order[s:s + self.batch_size]
                    negs = lt.sample_negatives(
                        rng, (len(sel), max(1, self.negative)))
                    dvj, syn1neg = _sgns_step(
                        dvj, syn1neg, self._put_batch(cs[sel]),
                        self._put_batch(os_[sel]), self._put_batch(negs), lr)
        self.doc_vectors = dvj.cpu().numpy()
        lt.syn1neg = syn1neg.cpu().numpy()

    # -- queries ------------------------------------------------------
    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        return None if i is None else self.doc_vectors[i]

    def infer_vector(self, text: str, steps: int = 50,
                     lr: float = 0.05) -> np.ndarray:
        """Gradient-descend a fresh doc vector against frozen word weights
        (ref: ParagraphVectors.inferVector)."""
        lt = self.lookup_table
        toks = self.tokenizer_factory.create(text).get_tokens()
        seq = np.array([i for i in (self.vocab.index_of(t) for t in toks)
                        if i >= 0], dtype=np.int32)
        rng = np.random.default_rng(self.seed + 99)
        v = self._put_table(((rng.random(self.layer_size) - 0.5)
                             / self.layer_size).astype(np.float32))[None, :]
        if len(seq) == 0:
            return v[0].cpu().numpy()
        frozen = self._put_table(lt.syn1neg)
        centers = self._put_batch(np.zeros(len(seq), np.int32))
        contexts = self._put_batch(seq)
        for _ in range(steps):
            negs = lt.sample_negatives(rng, (len(seq), max(1, self.negative)))
            # each step updates a fresh copy of the outputs: they stay frozen
            v, _ = _sgns_step(v, frozen.clone(), centers, contexts,
                              self._put_batch(negs), lr)
        return v[0].cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        iv = self.infer_vector(text)
        dv = self.get_doc_vector(label)
        denom = (np.linalg.norm(iv) * np.linalg.norm(dv)) or 1e-12
        return float(np.dot(iv, dv) / denom)
