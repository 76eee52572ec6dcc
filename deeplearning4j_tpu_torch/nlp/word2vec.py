"""Word2Vec: SequenceVectors over tokenized sentences.

Ref: deeplearning4j-nlp models/word2vec/Word2Vec.java (Builder wrapping
SequenceVectors with a SentenceIterator + TokenizerFactory).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory


class Word2Vec(SequenceVectors):
    """fit() accepts raw sentences (strings) or pre-tokenized sequences.

    Builder-style keyword args mirror the reference's
    Word2Vec.Builder().layerSize(..).windowSize(..).minWordFrequency(..)
    .iterations(..).negativeSample(..).useHierarchicSoftmax(..);
    ``device`` as ``SequenceVectors``'.
    """

    def __init__(self, tokenizer_factory: Optional[DefaultTokenizerFactory] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _tokenize(self, sentences: Iterable) -> List[Sequence[str]]:
        out = []
        for s in sentences:
            if isinstance(s, str):
                out.append(self.tokenizer_factory.create(s).get_tokens())
            else:
                out.append(list(s))
        return out

    def build_vocab(self, sentences: Iterable) -> None:  # type: ignore[override]
        super().build_vocab(self._tokenize(sentences))

    def fit(self, sentences) -> None:  # type: ignore[override]
        super().fit(self._tokenize(list(sentences)))
