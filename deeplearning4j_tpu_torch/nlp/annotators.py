"""Annotator pipeline: sentence / token / POS / stem / lemma analysis.

Ref: deeplearning4j-nlp-uima (3 085 LoC) wires UIMA AnalysisEngines —
text/annotator/{SentenceAnnotator,TokenizerAnnotator,PoStagger,
StemmerAnnotator}.java — into an AnalysisEngineDescription pipeline whose
results live as typed annotations over a CAS, consumed by
UimaSentenceIterator, PosUimaTokenizerFactory, and StemmingPreprocessor.

This module is that capability without the UIMA machinery: annotators are
composable objects writing typed ``Annotation`` spans into an
``AnnotatedText`` (the CAS analog), and the same three consumers are
provided (sentence iterator, POS-filtered tokenizer factory, stemming
token preprocessor). The POS tagger is a self-contained rule/lexicon
tagger (closed-class lexicon + suffix heuristics + contextual repair
passes — the classic Brill-style baseline); the stemmer is a full Porter
implementation (ref: StemmerAnnotator wraps snowball's Porter); the
lemmatizer adds an irregular-form table over the same rules.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CollectionSentenceIterator, _Tokenizer,
)

# ---------------------------------------------------------------------------
# CAS analog
# ---------------------------------------------------------------------------


@dataclass
class Annotation:
    """A typed text span (the UIMA Annotation analog)."""
    kind: str                    # "sentence" | "token"
    begin: int
    end: int
    features: Dict[str, str] = field(default_factory=dict)

    def covered_text(self, text: str) -> str:
        return text[self.begin:self.end]


class AnnotatedText:
    """Text plus typed annotations (the CAS analog)."""

    def __init__(self, text: str):
        self.text = text
        self.annotations: List[Annotation] = []

    def add(self, ann: Annotation) -> None:
        self.annotations.append(ann)

    def select(self, kind: str) -> List[Annotation]:
        return [a for a in self.annotations if a.kind == kind]

    def covered(self, kind: str, within: Annotation) -> List[Annotation]:
        return [a for a in self.annotations
                if a.kind == kind
                and a.begin >= within.begin and a.end <= within.end]

    def sentences(self) -> List[str]:
        return [a.covered_text(self.text) for a in self.select("sentence")]

    def tokens(self) -> List[str]:
        return [a.covered_text(self.text) for a in self.select("token")]


class Annotator:
    """Analysis-engine contract: mutate the AnnotatedText in place."""

    def process(self, cas: AnnotatedText) -> None:
        raise NotImplementedError


class AnnotatorPipeline:
    """Ordered annotators over one CAS (the AnalysisEngineDescription
    aggregate analog — ref SentenceAnnotator.getDescription chaining)."""

    def __init__(self, annotators: Sequence[Annotator]):
        self.annotators = list(annotators)

    def process(self, text: str) -> AnnotatedText:
        cas = AnnotatedText(text)
        for a in self.annotators:
            a.process(cas)
        return cas


# ---------------------------------------------------------------------------
# sentence segmentation
# ---------------------------------------------------------------------------

_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
           "e.g", "i.e", "fig", "no", "inc", "ltd", "co", "corp", "dept",
           "est", "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep",
           "sept", "oct", "nov", "dec", "u.s", "u.k"}


class SentenceAnnotator(Annotator):
    """Abbreviation-aware sentence boundary detection
    (ref: text/annotator/SentenceAnnotator.java)."""

    _END = re.compile(r"[.!?。！？]+[\"')\]」』]*")

    def process(self, cas: AnnotatedText) -> None:
        text = cas.text
        start, n = 0, len(text)
        for m in self._END.finditer(text):
            end = m.end()
            before = text[start:m.start()]
            last = re.split(r"\s+", before.strip())[-1] if before.strip() else ""
            low = last.lower().rstrip(".")
            # don't split after known abbreviations or single initials
            if (text[m.start()] == "."
                    and (low in _ABBREV or re.fullmatch(r"[a-z]", low))):
                continue
            # require following whitespace/EOL for latin periods
            if (text[m.start()] == "." and end < n
                    and not text[end].isspace()):
                continue
            seg = text[start:end].strip()
            if seg:
                b = text.index(seg[0], start)
                cas.add(Annotation("sentence", b, b + len(seg)))
            start = end
        tail = text[start:].strip()
        if tail:
            b = text.index(tail[0], start)
            cas.add(Annotation("sentence", b, b + len(tail)))


# ---------------------------------------------------------------------------
# tokenization
# ---------------------------------------------------------------------------


class TokenizerAnnotator(Annotator):
    """Add token annotations inside each sentence (or over the whole
    text when no sentence annotator ran before it)
    (ref: text/annotator/TokenizerAnnotator.java)."""

    _WORD = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)?|\d+(?:[.,]\d+)*|\S")

    def process(self, cas: AnnotatedText) -> None:
        spans = cas.select("sentence") or [
            Annotation("sentence", 0, len(cas.text))]
        for s in spans:
            for m in self._WORD.finditer(cas.text[s.begin:s.end]):
                cas.add(Annotation("token", s.begin + m.start(),
                                   s.begin + m.end()))


# ---------------------------------------------------------------------------
# POS tagging (Penn-style coarse tags)
# ---------------------------------------------------------------------------

_CLOSED: Dict[str, str] = {}
for w in ("the a an this that these those every each both all some any "
          "no neither either another".split()):
    _CLOSED[w] = "DT"
for w in ("children women men people feet teeth mice geese oxen".split()):
    _CLOSED[w] = "NNS"
for w in ("in on at by for with from to of over under into onto about "
          "through during between among against within".split()):
    _CLOSED[w] = "IN"
for w in ("i you he she it we they me him her us them".split()):
    _CLOSED[w] = "PRP"
for w in ("my your his its our their".split()):
    _CLOSED[w] = "PRP$"
for w in ("and or but nor yet so".split()):
    _CLOSED[w] = "CC"
_CLOSED.update({"is": "VBZ", "am": "VBP", "are": "VBP", "was": "VBD",
                "were": "VBD", "be": "VB", "been": "VBN",
                "being": "VBG", "have": "VBP", "has": "VBZ",
                "had": "VBD", "do": "VBP", "does": "VBZ", "did": "VBD"})
for w in ("will would can could shall should may might must".split()):
    _CLOSED[w] = "MD"
for w in ("not n't never".split()):
    _CLOSED[w] = "RB"
for w in ("very quite too also just still often always sometimes".split()):
    _CLOSED[w] = "RB"
for w in ("went said made took came saw knew got gave found thought told "
          "left felt kept held brought wrote ran ate spoke bought sold "
          "met sat stood lost won paid sent built spent").split():
    _CLOSED[w] = "VBD"
for w in ("near toward towards across along behind beside beneath above "
          "below around without until since despite inside outside "
          "upon per before after".split()):
    _CLOSED[w] = "IN"
for w in ("again soon now then twice once upstairs downstairs everywhere "
          "somewhere nowhere together carefully".split()):
    _CLOSED[w] = "RB"
for w in ("fell caught sang rang broke grew blew drew threw flew hid "
          "swept spun shone rode drove wore chose froze stole woke "
          "became began swam drank slid bit dug hung struck stuck swung "
          "fought taught sought laid rose shook forgot forgave "
          "understood arose slept crept dealt meant led bled fled "
          "strode clung flung wrung".split()):
    _CLOSED[w] = "VBD"
for w in ("one two three four five six seven eight nine ten eleven "
          "twelve thirteen fourteen fifteen sixteen seventeen eighteen "
          "nineteen twenty thirty forty fifty sixty seventy eighty "
          "ninety hundred thousand million billion".split()):
    _CLOSED[w] = "CD"
_CLOSED.update({"to": "TO", "there": "EX", "'s": "POS"})

# open-class helper lexicons (not in _CLOSED: the repair passes consult
# them contextually — e.g. 'flows' is NNS or VBZ depending on what
# precedes it, 'late' is JJ before a noun and RB after a verb)
_COMMON_ADJ = set(
    "small large big little old new young long short tall high low "
    "good bad great fine nice fresh clean dirty dark bright light "
    "heavy strong weak quick slow fast early late hot cold warm cool "
    "dry wet hard soft easy difficult simple quiet loud deep shallow "
    "wide narrow thick thin rich poor full empty open closed free "
    "busy happy sad angry tired hungry thirsty sick healthy dead "
    "alive red blue green yellow white black brown grey gray silver "
    "golden wooden steep huge tiny vast gentle cheerful sudden strange "
    "familiar salty sweet sour bitter delicious wonderful beautiful "
    "lovely ugly boring interesting important famous local foreign "
    "modern ancient sad whole main final several many few other same "
    "different next last certain true false real dusty friendly "
    "lonely lively elderly deadly costly cowardly orderly".split())
_VERB_BASES = set(
    "live flow sell open close arrive look sound need want teach grow "
    "rule lead connect attract offer own smell taste feel seem appear "
    "ripen rise lie feed speak drink want study sell check help work "
    "play move stop start turn call ask answer show tell know think "
    "believe remember forget win lose run walk come go leave reach "
    "bring take make give get put send pay buy cost mean keep hold "
    "stand sit love hate like enjoy watch wear carry push pull throw "
    "catch wash cook bake plant collapse practice practise happen".split())


class POSAnnotator(Annotator):
    """Rule/lexicon POS tagger with contextual repair
    (ref: text/annotator/PoStagger.java — OpenNLP's maxent tagger there;
    here a deterministic baseline with the same tag vocabulary)."""

    def _lexical(self, tok: str) -> str:
        low = tok.lower()
        if low in _CLOSED:
            return _CLOSED[low]
        if re.fullmatch(r"\d+(?:[.,]\d+)*", tok):
            return "CD"
        if not tok[0].isalnum():
            return "SYM" if len(tok) > 1 or tok not in ".,;:!?" else "."
        if tok[0].isupper():
            return "NNP"
        # lexicon beats suffix heuristics: 'friendly'/'lovely' are JJ
        # despite the -ly, 'early' is JJ here with a flat-adverb repair
        if low in _COMMON_ADJ:
            return "JJ"
        if low.endswith("ly"):
            return "RB"
        if low.endswith(("ing",)):
            return "VBG"
        if low.endswith(("ed",)):
            return "VBD"
        if low.endswith(("tion", "ment", "ness", "ity", "ance", "ence",
                         "ship", "ism", "er", "or", "ist")):
            return "NN"
        if low.endswith(("ous", "ful", "ive", "able", "ible", "al", "ic")):
            return "JJ"
        if low.endswith("s") and not low.endswith(("ss", "us", "is")):
            return "NNS"
        return "NN"

    def process(self, cas: AnnotatedText) -> None:
        for sent in (cas.select("sentence")
                     or [Annotation("sentence", 0, len(cas.text))]):
            toks = cas.covered("token", sent)
            tags = [self._lexical(t.covered_text(cas.text)) for t in toks]
            # contextual repair (Brill-style patches)
            for i, t in enumerate(toks):
                word = t.covered_text(cas.text).lower()
                # determiner/adjective -> following word is nominal
                if i and tags[i - 1] in ("DT", "PRP$", "JJ") \
                        and tags[i] in ("VBD", "VBG", "VB"):
                    tags[i] = "NN"
                # TO + base verb ("to run"; proper nouns stay NNP —
                # "to Washington" is a PP, not an infinitive). Tensed
                # lexicon tags (have->VBP etc.) drop to base form too.
                if i and tags[i - 1] == "TO" \
                        and tags[i] in ("NN", "VBP", "VBZ", "VBD"):
                    tags[i] = "VB"
                # modal + base verb ("will have" / "can do": the tensed
                # lexicon tags VBP/VBZ/VBD must also drop to base form)
                if i and tags[i - 1] == "MD" \
                        and (tags[i].startswith("NN")
                             or tags[i] in ("VBP", "VBZ", "VBD")):
                    tags[i] = "VB"
                # sentence-initial capitalized common word: untag NNP
                if i == 0 and tags[i] == "NNP" \
                        and self._lexical(word) != "NNP":
                    tags[i] = self._lexical(word)
                # subject + s-form of a known verb base: 'the river
                # flows', 'she speaks' — NNS is really VBZ
                if i and tags[i] == "NNS" \
                        and tags[i - 1] in ("NN", "NNP", "PRP"):
                    base = word[:-1]  # plain strip covers 'rises'->'rise'
                    if word.endswith("ies"):
                        base = word[:-3] + "y"
                    elif word.endswith(("ches", "shes", "sses", "xes")):
                        base = word[:-2]
                    if base in _VERB_BASES:
                        tags[i] = "VBZ"
                # 'her' before a nominal is possessive
                if word == "her" and i + 1 < len(tags) \
                        and tags[i + 1] in ("NN", "NNS", "JJ", "NNP"):
                    tags[i] = "PRP$"
                # flat adverbs after a verb ('arrived late')
                if word in ("late", "early", "fast", "hard") \
                        and i and tags[i - 1].startswith("VB"):
                    tags[i] = "RB"
            for t, tag in zip(toks, tags):
                t.features["pos"] = tag


# ---------------------------------------------------------------------------
# Porter stemmer + lemmatizer
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    m, i, n = 0, 0, len(stem)
    while i < n and _is_cons(stem, i):
        i += 1
    while True:
        while i < n and not _is_cons(stem, i):
            i += 1
        if i >= n:
            return m
        m += 1
        while i < n and _is_cons(stem, i):
            i += 1
        if i >= n:
            return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_cvc(stem: str) -> bool:
    if len(stem) < 3:
        return False
    return (_is_cons(stem, -3 + len(stem)) and
            not _is_cons(stem, -2 + len(stem)) and
            _is_cons(stem, -1 + len(stem)) and stem[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """The Porter (1980) algorithm, steps 1-5
    (ref: StemmerAnnotator.java wraps snowball's PorterStemmer)."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif (len(w) >= 2 and w[-1] == w[-2]
                    and _is_cons(w, len(w) - 1) and w[-1] not in "lsz"):
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"),
                     ("enci", "ence"), ("anci", "ance"), ("izer", "ize"),
                     ("abli", "able"), ("alli", "al"), ("entli", "ent"),
                     ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
                     ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
                     ("iveness", "ive"), ("fulness", "ful"),
                     ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 1:
                w = w[:-len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1
                                  and not _ends_cvc(stem)):
            w = stem
    # step 5b
    if w.endswith("ll") and _measure(w) > 1:
        w = w[:-1]
    return w


_IRREGULAR_LEMMAS = {
    "was": "be", "were": "be", "is": "be", "am": "be", "are": "be",
    "been": "be", "being": "be", "has": "have", "had": "have",
    "having": "have", "does": "do", "did": "do", "done": "do",
    "went": "go", "gone": "go", "goes": "go", "said": "say",
    "made": "make", "took": "take", "taken": "take", "came": "come",
    "saw": "see", "seen": "see", "knew": "know", "known": "know",
    "got": "get", "gotten": "get", "gave": "give", "given": "give",
    "found": "find", "thought": "think", "told": "tell", "left": "leave",
    "felt": "feel", "kept": "keep", "held": "hold", "brought": "bring",
    "wrote": "write", "written": "write", "ran": "run", "ate": "eat",
    "eaten": "eat", "spoke": "speak", "spoken": "speak", "men": "man",
    "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "mice": "mouse", "better": "good",
    "best": "good", "worse": "bad", "worst": "bad",
}


def lemmatize(word: str, pos: Optional[str] = None) -> str:
    """Dictionary-form lemma: irregular table first, then POS-aware
    suffix rules (unlike the stemmer, outputs are real words)."""
    low = word.lower()
    if low in _IRREGULAR_LEMMAS:
        return _IRREGULAR_LEMMAS[low]
    if pos is None or pos.startswith("NN"):
        if low.endswith("ies") and len(low) > 4:
            return low[:-3] + "y"
        if low.endswith(("ches", "shes", "xes", "sses", "zes")):
            return low[:-2]
        if low.endswith("s") and not low.endswith(("ss", "us", "is")) \
                and len(low) > 3:
            return low[:-1]
    if pos is None or pos.startswith("VB"):
        if low.endswith("ying") and len(low) > 5:
            return low[:-4] + "y"
        if low.endswith("ing") and len(low) > 5:
            stem = low[:-3]
            if len(stem) >= 2 and stem[-1] == stem[-2] \
                    and stem[-1] not in "ls":
                return stem[:-1]
            if _ends_cvc(stem):
                return stem + "e"
            return stem
        if low.endswith("ied") and len(low) > 4:
            return low[:-3] + "y"
        if low.endswith("ed") and len(low) > 4:
            stem = low[:-2]
            if len(stem) >= 2 and stem[-1] == stem[-2] \
                    and stem[-1] not in "ls":
                return stem[:-1]
            if _ends_cvc(stem):
                return stem + "e"
            return stem
    return low


class StemmerAnnotator(Annotator):
    """Porter-stem every token into features['stem']
    (ref: text/annotator/StemmerAnnotator.java)."""

    def process(self, cas: AnnotatedText) -> None:
        for t in cas.select("token"):
            t.features["stem"] = porter_stem(t.covered_text(cas.text))


class LemmaAnnotator(Annotator):
    """Lemmatize every token into features['lemma'], POS-aware when a
    POSAnnotator ran earlier in the pipeline."""

    def process(self, cas: AnnotatedText) -> None:
        for t in cas.select("token"):
            t.features["lemma"] = lemmatize(t.covered_text(cas.text),
                                            t.features.get("pos"))


def default_pipeline() -> AnnotatorPipeline:
    """sentence -> token -> POS -> stem -> lemma (the UimaResource
    default aggregate analog)."""
    return AnnotatorPipeline([SentenceAnnotator(), TokenizerAnnotator(),
                              POSAnnotator(), StemmerAnnotator(),
                              LemmaAnnotator()])


# ---------------------------------------------------------------------------
# consumers (the three UIMA integration points)
# ---------------------------------------------------------------------------


class AnnotatorSentenceIterator(CollectionSentenceIterator):
    """SentenceIterator over pipeline-segmented documents
    (ref: text/sentenceiterator/UimaSentenceIterator.java)."""

    def __init__(self, documents: Sequence[str],
                 pipeline: Optional[AnnotatorPipeline] = None):
        pipe = pipeline or AnnotatorPipeline([SentenceAnnotator()])
        sentences: List[str] = []
        for doc in documents:
            sentences.extend(pipe.process(doc).sentences())
        super().__init__(sentences)


class PosTokenizerFactory:
    """Tokenizer factory keeping only tokens whose POS tag is in
    ``allowed`` (ref: tokenizerfactory/PosUimaTokenizerFactory.java);
    ``lemmatized=True`` emits lemmas instead of surfaces."""

    def __init__(self, allowed: Sequence[str], lemmatized: bool = False):
        self.allowed = set(allowed)
        self.lemmatized = lemmatized
        self._pipe = AnnotatorPipeline(
            [SentenceAnnotator(), TokenizerAnnotator(), POSAnnotator(),
             LemmaAnnotator()])

    def create(self, text: str) -> _Tokenizer:
        cas = self._pipe.process(text)
        out = []
        for t in cas.select("token"):
            if any(t.features.get("pos", "").startswith(a)
                   for a in self.allowed):
                out.append(t.features["lemma"] if self.lemmatized
                           else t.covered_text(cas.text))
        return _Tokenizer(out)


class StemmingPreprocessor:
    """TokenPreProcess applying the Porter stemmer after the common
    cleanup (ref: tokenizer/preprocessor/StemmingPreprocessor.java)."""

    def pre_process(self, token: str) -> str:
        from deeplearning4j_tpu_torch.nlp.tokenization import CommonPreprocessor
        return porter_stem(CommonPreprocessor().pre_process(token))
