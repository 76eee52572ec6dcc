"""Tokenizers, token preprocessors, sentence iterators, labels source.

Ref: deeplearning4j-nlp text/tokenization/tokenizerfactory/
{DefaultTokenizerFactory,NGramTokenizerFactory}.java,
text/tokenization/tokenizer/preprocessor/CommonPreprocessor.java,
text/sentenceiterator/{BasicLineIterator,CollectionSentenceIterator}.java,
text/documentiterator/LabelsSource.java, text/stopwords/StopWords.java.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

# Subset of the reference's stopwords list (text/stopwords resource).
STOP_WORDS = frozenset("""
a an and are as at be but by for if in into is it no not of on or such that
the their then there these they this to was will with
""".split())


class CommonPreprocessor:
    """Lowercase + strip punctuation/digits, like the reference's
    CommonPreprocessor (removes everything matching [\\d\\.:,"'\\(\\)\\[\\]|/?!;]+)."""

    _PAT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PAT.sub("", token).lower()


class _Tokenizer:
    def __init__(self, tokens: List[str]):
        self.tokens = tokens

    def get_tokens(self) -> List[str]:
        return list(self.tokens)

    def count_tokens(self) -> int:
        return len(self.tokens)

    def __iter__(self):
        return iter(self.tokens)


class DefaultTokenizerFactory:
    """Whitespace tokenizer with an optional per-token preprocessor."""

    def __init__(self, preprocessor: Optional[CommonPreprocessor] = None):
        self.preprocessor = preprocessor

    def set_token_pre_processor(self, p) -> None:
        self.preprocessor = p

    def create(self, text: str) -> _Tokenizer:
        toks = text.split()
        if self.preprocessor is not None:
            toks = [self.preprocessor.pre_process(t) for t in toks]
        return _Tokenizer([t for t in toks if t])


class NGramTokenizerFactory:
    """Emits all n-grams (joined by spaces) for n in [min_n, max_n].

    Ref: NGramTokenizerFactory.java / NGramTokenizer.java.
    """

    def __init__(self, base: Optional[DefaultTokenizerFactory] = None,
                 min_n: int = 1, max_n: int = 2):
        self.base = base or DefaultTokenizerFactory()
        self.min_n, self.max_n = min_n, max_n

    def create(self, text: str) -> _Tokenizer:
        words = self.base.create(text).get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(words) - n + 1):
                out.append(" ".join(words[i:i + n]))
        return _Tokenizer(out)


class CollectionSentenceIterator:
    """Iterates an in-memory list of sentences (ref:
    CollectionSentenceIterator.java); restartable via reset()."""

    def __init__(self, sentences: Sequence[str]):
        self._sentences = list(sentences)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def next_sentence(self) -> str:
        s = self._sentences[self._pos]
        self._pos += 1
        return s

    def reset(self) -> None:
        self._pos = 0

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class BasicLineIterator(CollectionSentenceIterator):
    """One sentence per line from a UTF-8 file (ref: BasicLineIterator.java)."""

    def __init__(self, path):
        text = Path(path).read_text(encoding="utf-8")
        super().__init__([ln for ln in text.splitlines() if ln.strip()])


class LabelsSource:
    """Generates/stores document labels for ParagraphVectors
    (ref: text/documentiterator/LabelsSource.java)."""

    def __init__(self, template: str = "DOC_%d",
                 labels: Optional[List[str]] = None):
        self.template = template
        self._labels: List[str] = list(labels) if labels else []
        self._counter = len(self._labels)

    def next_label(self) -> str:
        label = self.template % self._counter
        self._counter += 1
        self._labels.append(label)
        return label

    def store_label(self, label: str) -> None:
        if label not in self._labels:
            self._labels.append(label)

    def get_labels(self) -> List[str]:
        return list(self._labels)
