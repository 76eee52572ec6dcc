"""Language-specific tokenizer add-ons.

Ref: deeplearning4j-nlp-japanese (a bundled Kuromoji fork — full
morphological analysis, ~6.8k LoC), deeplearning4j-nlp-korean (wrapper
around open-korean-text), deeplearning4j-nlp-uima (sentence/POS/lemma
annotators). Those lean on large external models; the capability here —
pluggable TokenizerFactory implementations that segment non-whitespace
scripts and filter by part of speech — is provided with self-contained
rule-based segmenters (no external dictionaries in the image):

- JapaneseTokenizerFactory: script-run segmentation (kanji / hiragana /
  katakana / latin / digit runs), the standard dictionary-free fallback.
- KoreanTokenizerFactory: whitespace segmentation with optional stripping
  of common particles (josa).
- PosFilterTokenizerFactory: keeps tokens whose (heuristic, suffix-rule)
  POS tag is in an allow-list — the PosUimaTokenizer role.
- RegexSentenceIterator: sentence segmentation (UimaSentenceIterator role).
"""

from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CollectionSentenceIterator, _Tokenizer,
)


def _script(ch: str) -> str:
    o = ord(ch)
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or o == 0x30FC:
        return "katakana"
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
        return "kanji"
    if 0xAC00 <= o <= 0xD7AF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


class JapaneseTokenizerFactory:
    """Script-run segmentation for Japanese text (the dictionary-free
    stand-in for the bundled Kuromoji fork). Adjacent characters of the
    same script class form one token; kanji runs additionally split from
    following hiragana (okurigana stay attached to the hiragana run)."""

    def create(self, text: str) -> _Tokenizer:
        tokens: List[str] = []
        cur = ""
        cur_script = None
        for ch in text:
            s = _script(ch)
            if s in ("space", "other"):
                if cur:
                    tokens.append(cur)
                cur, cur_script = "", None
                continue
            if s == cur_script:
                cur += ch
            else:
                if cur:
                    tokens.append(cur)
                cur, cur_script = ch, s
        if cur:
            tokens.append(cur)
        return _Tokenizer(tokens)


# most common single/double-char josa particles
_JOSA = ("은", "는", "이", "가", "을", "를", "에", "의", "와", "과",
         "도", "로", "으로", "에서", "에게", "부터", "까지", "처럼")


class KoreanTokenizerFactory:
    """Whitespace segmentation with optional josa (particle) stripping —
    the role of the reference's open-korean-text wrapper."""

    def __init__(self, strip_particles: bool = True):
        self.strip_particles = strip_particles

    def create(self, text: str) -> _Tokenizer:
        tokens = []
        for tok in text.split():
            tok = tok.strip(".,!?()[]\"'")
            if not tok:
                continue
            if self.strip_particles and len(tok) > 1:
                for josa in sorted(_JOSA, key=len, reverse=True):
                    if tok.endswith(josa) and len(tok) > len(josa):
                        tok = tok[:-len(josa)]
                        break
            tokens.append(tok)
        return _Tokenizer(tokens)


_POS_RULES = [
    (re.compile(r".*(ing|ed)$"), "VB"),
    (re.compile(r".*(ly)$"), "RB"),
    (re.compile(r".*(ful|ous|ive|able|ible|al|ic)$"), "JJ"),
    (re.compile(r".*(tion|ment|ness|ity|er|or|ist|ism)$"), "NN"),
    (re.compile(r"^[0-9]+([.,][0-9]+)?$"), "CD"),
]
_CLOSED = {"the": "DT", "a": "DT", "an": "DT", "and": "CC", "or": "CC",
           "but": "CC", "in": "IN", "on": "IN", "at": "IN", "of": "IN",
           "to": "TO", "is": "VBZ", "are": "VBP", "was": "VBD",
           "he": "PRP", "she": "PRP", "it": "PRP", "they": "PRP"}


def pos_tag(token: str) -> str:
    """Heuristic suffix-rule tagger (the UIMA annotator stand-in)."""
    low = token.lower()
    if low in _CLOSED:
        return _CLOSED[low]
    for rx, tag in _POS_RULES:
        if rx.match(low):
            return tag
    return "NN"


class PosFilterTokenizerFactory:
    """Keep only tokens whose POS tag is allowed (ref: nlp-uima
    PosUimaTokenizer — others are dropped rather than masked)."""

    def __init__(self, allowed_tags: Sequence[str],
                 base: Optional[object] = None):
        from deeplearning4j_tpu_torch.nlp.tokenization import (
            DefaultTokenizerFactory)
        self.allowed = set(allowed_tags)
        self.base = base or DefaultTokenizerFactory()

    def create(self, text: str) -> _Tokenizer:
        toks = self.base.create(text).get_tokens()
        return _Tokenizer([t for t in toks if pos_tag(t) in self.allowed])


# latin terminators need trailing whitespace; CJK terminators split at a
# zero-width boundary (no space convention in CJK text)
_SENT_RE = re.compile(r"(?<=[.!?])\s+|(?<=[。！？])\s*")


class RegexSentenceIterator(CollectionSentenceIterator):
    """Sentence segmentation from raw text (ref: nlp-uima
    UimaSentenceIterator role)."""

    def __init__(self, text: str):
        text = unicodedata.normalize("NFC", text).strip()
        sents = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
        super().__init__(sents)
