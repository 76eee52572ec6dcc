"""The port's text modules against the JAX package's, on the CPU:
tokenizers, the lattice tokenizer and its lexicon, annotators, the tree
parser with ``TreeVectorizer``, sentiment.

Held here:
- every tokenizer's tokens, ``pos_tag`` and the sentence iterators equal
  to the JAX package's on the same texts;
- the lattice tokenizer's morphemes (surface, POS, base form, start) and
  its generated lexicon equal;
- the annotator pipeline's sentences, tokens and features (POS, stem,
  lemma) equal on the POS gold fixture;
- the tree parser's Penn trees, binarized and collapsed, with head words,
  equal; ``TreeVectorizer``'s node vectors within 1e-5 of the largest |x|
  (at least 1) after ``convert.tree_vectorizer_from_jax``;
- the sentiment scores equal on the sentiment gold fixture;
- the JAX package's gates mirrored on the port:
  ``tests/test_sentiment.py``, ``tests/test_lattice_tokenizer.py``,
  ``tests/test_treeparser.py``, ``tests/test_annotators.py`` and the
  tokenizer cases of ``tests/test_ui_components_tokenizers.py``.
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

import deeplearning4j_tpu.nlp as J
from deeplearning4j_tpu.nlp import annotators as jann
from deeplearning4j_tpu.nlp import lattice_tokenizer as jlat
from deeplearning4j_tpu.nlp import treeparser as jtree

from deeplearning4j_tpu_torch.convert import tree_vectorizer_from_jax
from deeplearning4j_tpu_torch.nlp import (
    CommonPreprocessor, DefaultTokenizerFactory, JapaneseTokenizerFactory,
    KoreanTokenizerFactory, NGramTokenizerFactory, PosFilterTokenizerFactory,
    RegexSentenceIterator, SentimentAnalyzer, STOP_WORDS, pos_tag,
)
from deeplearning4j_tpu_torch.nlp import annotators as pann
from deeplearning4j_tpu_torch.nlp import lattice_tokenizer as plat
from deeplearning4j_tpu_torch.nlp.annotators import (
    AnnotatorPipeline, AnnotatorSentenceIterator, LemmaAnnotator,
    POSAnnotator, PosTokenizerFactory, SentenceAnnotator,
    StemmerAnnotator, StemmingPreprocessor, TokenizerAnnotator,
    default_pipeline, lemmatize, porter_stem,
)
from deeplearning4j_tpu_torch.nlp.lattice_tokenizer import (
    AUX, NOUN, PARTICLE, JapaneseLatticeTokenizer,
    JapaneseLatticeTokenizerFactory, Morpheme, UNK,
)
from deeplearning4j_tpu_torch.nlp.treeparser import (
    BinarizeTreeTransformer, CollapseUnaries, HeadWordFinder, Tree,
    TreeIterator, TreeParser, TreeVectorizer,
)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
FWD = 1e-5

TEXTS = [
    "Hello, World! 123 foo.bar -- the quick brown fox's tail.",
    "Dr. Smith arrived. He met Mrs. Jones at 5 p.m. sharp! Was he late? No.",
    "The movement measured 42 units quickly; carefully running, jumped.",
    "私はJAXでモデルを書く。これはペンです。",
    "나는 학교에 간다. 친구와 도서관에서 공부를 했다!",
    "One sentence. Two! Three? 四つ目。 Five",
]
JA_TEXTS = [
    "すもももももももものうち", "私は学生です", "昨日映画を見ました",
    "東京都に住んでいます", "ヘリコプターを使う", "3円です",
    "大きな犬がいる", "いい天気です", "問題がない", "私は 学生です",
    "昨日の会議で新しい計画を説明した。三十五人の社員が参加して、"
    "二時間ほど議論を続けた。",
    "彼女は大学で経済を研究している。留学を希望する学生に紹介された。",
]


def _gold_sentences(name, n=None):
    out = []
    for line in open(FIXTURES / name, encoding="utf-8"):
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        out.append(line.split("\t", 1)[1] if name == "sentiment_gold.txt"
                   else " ".join(t.rsplit("_", 1)[0] for t in line.split()))
    return out[:n]


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def test_tokenizers_equal_jax():
    assert STOP_WORDS == J.STOP_WORDS
    pairs = [
        (DefaultTokenizerFactory(), J.DefaultTokenizerFactory()),
        (DefaultTokenizerFactory(CommonPreprocessor()),
         J.DefaultTokenizerFactory(J.CommonPreprocessor())),
        (NGramTokenizerFactory(min_n=1, max_n=3),
         J.NGramTokenizerFactory(min_n=1, max_n=3)),
        (JapaneseTokenizerFactory(), J.JapaneseTokenizerFactory()),
        (KoreanTokenizerFactory(), J.KoreanTokenizerFactory()),
        (KoreanTokenizerFactory(strip_particles=False),
         J.KoreanTokenizerFactory(strip_particles=False)),
        (PosFilterTokenizerFactory(["NN", "CD", "VB"]),
         J.PosFilterTokenizerFactory(["NN", "CD", "VB"])),
        (PosTokenizerFactory(["NN", "VBD"], lemmatized=True),
         J.PosTokenizerFactory(["NN", "VBD"], lemmatized=True)),
        (DefaultTokenizerFactory(StemmingPreprocessor()),
         J.DefaultTokenizerFactory(J.StemmingPreprocessor())),
    ]
    for p, j in pairs:
        for text in TEXTS:
            tok = p.create(text)
            assert tok.get_tokens() == j.create(text).get_tokens(), text
            assert tok.count_tokens() == len(tok.get_tokens())
    for text in TEXTS:
        assert list(RegexSentenceIterator(text)) == list(
            J.RegexSentenceIterator(text))
        assert list(AnnotatorSentenceIterator([text, text[:20]])) == list(
            J.AnnotatorSentenceIterator([text, text[:20]]))
        for w in text.split():
            assert pos_tag(w) == J.pos_tag(w)


def _morphemes(ms):
    return [dataclasses.astuple(m) for m in ms]


def test_lattice_tokenizer_and_lexicon_equal_jax():
    assert plat._entries() == jlat._entries()
    p, j = JapaneseLatticeTokenizer(), jlat.JapaneseLatticeTokenizer()
    for text in JA_TEXTS:
        assert _morphemes(p.tokenize(text)) == _morphemes(j.tokenize(text))
    for pos_tags in (False, True):
        pf = JapaneseLatticeTokenizerFactory(pos_tags=pos_tags)
        jf = jlat.JapaneseLatticeTokenizerFactory(pos_tags=pos_tags)
        for text in JA_TEXTS:
            assert pf.create(text).get_tokens() == jf.create(
                text).get_tokens()


def _annotated(cas):
    return (cas.sentences(),
            [(t.begin, t.end, dict(t.features))
             for t in cas.select("token")])


def test_annotators_equal_jax_on_the_pos_gold():
    sents = _gold_sentences("pos_gold.txt")
    pp, jp = default_pipeline(), jann.default_pipeline()
    for text in sents + TEXTS:
        assert _annotated(pp.process(text)) == _annotated(jp.process(text))
    words = {w.lower() for s in sents for w in s.split()}
    for w in sorted(words):
        assert porter_stem(w) == jann.porter_stem(w), w
        for pos in (None, "NNS", "VBD", "VBG", "VBZ"):
            assert lemmatize(w, pos) == jann.lemmatize(w, pos), (w, pos)


def test_tree_parser_equal_jax():
    pparser, jparser = TreeParser(), jtree.TreeParser()
    texts = _gold_sentences("sentiment_gold.txt") + TEXTS[:3]
    for text in texts:
        pt, jt = pparser.trees_for(text), jparser.trees_for(text)
        assert [t.to_penn() for t in pt] == [t.to_penn() for t in jt]
        for a, b in zip(pt, jt):
            ab = BinarizeTreeTransformer().transform(a)
            bb = jtree.BinarizeTreeTransformer().transform(b)
            assert ab.to_penn() == bb.to_penn()
            HeadWordFinder().annotate(ab)
            jtree.HeadWordFinder().annotate(bb)
            assert [n.head_word for n in ab.preorder()] == [
                n.head_word for n in bb.preorder()]
            assert CollapseUnaries().transform(a).to_penn() == \
                jtree.CollapseUnaries().transform(b).to_penn()
    assert [t.to_penn() for t in TreeIterator(texts[:5])] == [
        t.to_penn() for t in jtree.TreeIterator(texts[:5])]


def _lookup(dim):
    table = {}

    def lookup(tok):
        key = tok.lower()
        if key == "the":
            return None                       # an OOV token: zeros
        if key not in table:
            seed = sum(ord(c) * 31 ** i for i, c in enumerate(key)) % 2**32
            table[key] = np.random.default_rng(seed).normal(
                size=dim).astype(np.float32)
        return table[key]
    return lookup


def test_tree_vectorizer_matches_jax_with_carried_weights():
    dim = 16
    jtv = jtree.TreeVectorizer(_lookup(dim), dim=dim, seed=3)
    ptv = TreeVectorizer(_lookup(dim), dim=dim, seed=11, device="cpu")
    tree_vectorizer_from_jax(jtv, ptv)
    assert np.array_equal(ptv.W.numpy(), np.asarray(jtv.W))
    texts = _gold_sentences("sentiment_gold.txt", 12)
    for text in texts:
        pt, jt = ptv.vectorize(text), jtv.vectorize(text)
        assert len(pt) == len(jt)
        for a, b in zip(pt, jt):
            assert a.to_penn() == b.to_penn()
            for na, nb in zip(a.preorder(), b.preorder()):
                assert na.vector.dtype == np.float32
                np.testing.assert_allclose(na.vector, nb.vector, rtol=0,
                                           atol=FWD)
    # a mixed node (token + children) composes its token in too
    for penn in ("(X foo (Y (A a) (B b)))", "(S (NP (NN dog)) (VP ran))"):
        pa = ptv.vectorize_tree(Tree.from_penn(penn))
        ja = jtv.vectorize_tree(jtree.Tree.from_penn(penn))
        np.testing.assert_allclose(pa.vector, ja.vector, rtol=0, atol=FWD)
    with pytest.raises(ValueError, match="does not match"):
        tree_vectorizer_from_jax(jtv, TreeVectorizer(_lookup(4), 4,
                                                     device="cpu"))


def test_sentiment_equal_jax_on_the_gold():
    ps, js = SentimentAnalyzer(), J.SentimentAnalyzer()
    for text in _gold_sentences("sentiment_gold.txt") + TEXTS:
        assert ps.score_text(text) == js.score_text(text)
        assert ps.classify(text) == js.classify(text)
    for w in ("excellent", "enjoying", "horribly", "table", "crashing"):
        assert ps.word_score(w) == js.word_score(w)


# ---------------------------------------------------------------------------
# tests/test_ui_components_tokenizers.py's tokenizer cases, on the port
# ---------------------------------------------------------------------------

def test_japanese_script_runs():
    from deeplearning4j_tpu_torch.nlp import JapaneseTokenizerFactory
    toks = JapaneseTokenizerFactory().create(
        "私はJAXでモデルを書く。").get_tokens()
    assert "JAX" in toks
    assert "モデル" in toks          # katakana run kept whole
    assert all("。" not in t for t in toks)


def test_korean_particle_strip():
    from deeplearning4j_tpu_torch.nlp import KoreanTokenizerFactory
    toks = KoreanTokenizerFactory().create("나는 학교에 간다").get_tokens()
    assert "학교" in toks            # 에 particle stripped
    raw = KoreanTokenizerFactory(strip_particles=False).create(
        "나는 학교에 간다").get_tokens()
    assert "학교에" in raw


def test_pos_filter():
    from deeplearning4j_tpu_torch.nlp import PosFilterTokenizerFactory, pos_tag
    assert pos_tag("running") == "VB"
    assert pos_tag("quickly") == "RB"
    assert pos_tag("the") == "DT"
    f = PosFilterTokenizerFactory(allowed_tags=["NN", "CD"])
    toks = f.create("the movement measured 42 units quickly").get_tokens()
    assert "movement" in toks and "42" in toks
    assert "the" not in toks and "quickly" not in toks


def test_sentence_iterator():
    from deeplearning4j_tpu_torch.nlp import RegexSentenceIterator
    it = RegexSentenceIterator("One sentence. Two! Three? 四つ目。 Five")
    sents = list(it)
    assert sents[0] == "One sentence."
    assert len(sents) == 5


def test_sentence_iterator_cjk_no_spaces():
    from deeplearning4j_tpu_torch.nlp import RegexSentenceIterator
    sents = list(RegexSentenceIterator("これはペンです。それは本です。"))
    assert sents == ["これはペンです。", "それは本です。"]


# ---------------------------------------------------------------------------
# tests/test_lattice_tokenizer.py, on the port
# ---------------------------------------------------------------------------

def _surfaces(ms):
    return [m.surface for m in ms]


def test_sumomo_classic():
    """The classic lattice test: すもももももももものうち must segment as
    plum/also/peach/also/peach/of/among — greedy or script-run
    segmentation cannot produce this; only min-cost search can."""
    t = JapaneseLatticeTokenizer()
    ms = t.tokenize("すもももももももものうち")
    assert _surfaces(ms) == ["すもも", "も", "もも", "も", "もも", "の",
                             "うち"]
    assert [m.pos for m in ms] == [NOUN, PARTICLE, NOUN, PARTICLE, NOUN,
                                   PARTICLE, NOUN]


def test_basic_sentences():
    t = JapaneseLatticeTokenizer()
    assert _surfaces(t.tokenize("私は学生です")) == ["私", "は", "学生",
                                                    "です"]
    assert _surfaces(t.tokenize("猫がいる")) == ["猫", "が", "いる"]
    assert _surfaces(t.tokenize("昨日映画を見ました")) == [
        "昨日", "映画", "を", "見", "ました"]


def test_pos_tags_and_base_forms():
    t = JapaneseLatticeTokenizer()
    ms = t.tokenize("食べました")
    assert _surfaces(ms) == ["食べ", "ました"]
    assert ms[0].base_form == "食べる"  # inflected stem -> dictionary form
    assert ms[1].pos == AUX and ms[1].base_form == "ます"


def test_compound_place_name_uses_suffix():
    """東京都 = 東京 (noun) + 都 (suffix) — the Kuromoji/IPADIC split."""
    t = JapaneseLatticeTokenizer()
    ms = t.tokenize("東京都に住んでいます")
    assert _surfaces(ms)[:3] == ["東京", "都", "に"]


def test_unknown_words_are_single_script_runs():
    """OOV katakana/kanji runs come out whole (unk.def analog), not
    char-by-char, and neighbors still resolve from the dictionary."""
    t = JapaneseLatticeTokenizer()
    # ヘリコプター is OOV; コンピュータ is now a dictionary loanword
    # (the generated lexicon, ja_lexicon.py)
    ms = t.tokenize("ヘリコプターを使う")
    assert _surfaces(ms) == ["ヘリコプター", "を", "使う"]
    assert ms[0].pos == UNK
    ms = t.tokenize("コンピュータを使う")
    assert _surfaces(ms) == ["コンピュータ", "を", "使う"]
    assert ms[0].pos == "noun"
    ms = t.tokenize("私の名前は田中です")
    assert _surfaces(ms) == ["私", "の", "名前", "は", "田中", "です"]


def test_numbers_and_counters():
    t = JapaneseLatticeTokenizer()
    ms = t.tokenize("3円です")
    assert _surfaces(ms) == ["3", "円", "です"]


def test_factory_protocol_and_pos_mode():
    f = JapaneseLatticeTokenizerFactory()
    tok = f.create("猫がいる")
    assert tok.get_tokens() == ["猫", "が", "いる"]
    assert tok.count_tokens() == 3
    fp = JapaneseLatticeTokenizerFactory(pos_tags=True)
    assert fp.create("猫がいる").get_tokens() == [
        "猫/noun", "が/particle", "いる/verb"]


def test_whitespace_and_empty():
    t = JapaneseLatticeTokenizer()
    assert t.tokenize("") == []
    assert _surfaces(t.tokenize("私は 学生です")) == ["私", "は", "学生",
                                                     "です"]


def test_morpheme_positions():
    t = JapaneseLatticeTokenizer()
    ms = t.tokenize("猫がいる")
    assert [(m.start, m.surface) for m in ms] == [(0, "猫"), (1, "が"),
                                                  (2, "いる")]


def test_generated_lexicon_scale_and_conjugations():
    """The generated lexicon (ja_lexicon) is dictionary-scale relative to
    the r3 hand-list (~300): thousands of surfaces, with full verb
    paradigms resolving to their dictionary base form."""
    from deeplearning4j_tpu_torch.nlp.lattice_tokenizer import _entries
    from deeplearning4j_tpu_torch.nlp.ja_lexicon import (
        conjugate_i_adjective, conjugate_verb)

    lex = _entries()
    assert len(lex) > 2000

    forms = dict(conjugate_verb("書く", "godan"))
    assert forms == {"書く": "dict", "書き": "cont", "書いて": "te",
                     "書いた": "ta", "書かない": "neg",
                     "書かなかった": "neg", "書ける": "pot",
                     "書かれる": "pass", "書こう": "vol",
                     "書けば": "cond", "書け": "imp"}
    # the classic euphonic exception
    assert ("行って", "te") in conjugate_verb("行く", "godan")
    # voiced te-form for む-row
    assert ("飲んで", "te") in conjugate_verb("飲む", "godan")
    assert ("食べられる", "pass") in conjugate_verb("食べる", "ichidan")
    assert ("勉強して", "te") in conjugate_verb("勉強する", "suru")
    assert ("高かった", "past") in conjugate_i_adjective("高い")

    t = JapaneseLatticeTokenizer()
    # every paradigm form lattice-resolves back to the dictionary form
    for surface in ("書いて", "書かなかった", "飲んで", "食べられる"):
        (m,) = [m for m in t.tokenize(surface)]
        assert m.base_form in ("書く", "飲む", "食べる"), (surface, m)


def test_irregular_adjectives_and_aru_negation():
    """Review r4: 大きな/小さな/いい must segment as adjectives with the
    right base form, and *あらない must not exist (ある negates to ない)."""
    t = JapaneseLatticeTokenizer()
    ms = t.tokenize("大きな犬がいる")
    assert [m.surface for m in ms] == ["大きな", "犬", "が", "いる"]
    assert ms[0].pos == "adjective" and ms[0].base_form == "大きい"
    ms = t.tokenize("いい天気です")
    assert [m.surface for m in ms] == ["いい", "天気", "です"]
    assert ms[0].base_form == "良い"
    from deeplearning4j_tpu_torch.nlp.lattice_tokenizer import _entries
    lex = _entries()
    assert "あらない" not in lex and "静かい" not in lex
    # ある + ない resolves through the AUX path
    ms = t.tokenize("問題がない")
    assert [m.surface for m in ms] == ["問題", "が", "ない"]


def test_segmentation_long_passage():
    """Natural multi-sentence passage (r5 lexicon scale-up): the
    suru-compounds, counters, and extended vocabulary segment as single
    morphemes instead of falling to unknown-word runs."""
    tok = JapaneseLatticeTokenizer()
    text = ("昨日の会議で新しい計画を説明した。"
            "三十五人の社員が参加して、二時間ほど議論を続けた。"
            "部長は予算の問題を指摘したが、最終的に全員が賛成した。"
            "来週までに資料を準備して、百二十万円の費用を申請する予定だ。")
    ms = tok.tokenize(text)
    surfaces = [m.surface for m in ms]
    for w in ("会議", "計画", "説明した", "三十五人", "社員",
              "参加して", "二時間", "議論", "指摘した", "賛成した",
              "資料", "準備して", "費用", "申請する", "予定"):
        assert w in surfaces, (w, surfaces)
    # numeral+counter compounds came out of the NUMBER generator
    n35 = ms[surfaces.index("三十五人")]
    assert n35.pos == "number", n35
    # coverage: no unknown runs in this everyday-register passage
    # (punctuation is SYMBOL, not UNK, since the r5 lexicon)
    unknowns = [m.surface for m in ms if m.pos == UNK]
    assert not unknowns, unknowns
    assert ms[[m.surface for m in ms].index("。")].pos == "symbol"


def test_segmentation_suru_paradigm_passage():
    tok = JapaneseLatticeTokenizer()
    ms = tok.tokenize("彼女は大学で経済を研究している。留学を希望する学生に紹介された。")
    surfaces = [m.surface for m in ms]
    for w in ("大学", "経済", "研究して", "留学", "希望する",
              "学生", "紹介された"):
        assert w in surfaces, (w, surfaces)
    base = {m.surface: m.base_form for m in ms}
    assert base.get("研究して") == "研究する"
    assert base.get("紹介された", "").startswith("紹介")


def test_lexicon_scale_floor():
    """VERDICT r4 #10 'Done' criterion: >=20k unique surfaces."""
    from deeplearning4j_tpu_torch.nlp.lattice_tokenizer import _entries
    assert len(_entries()) >= 20000


# ---------------------------------------------------------------------------
# tests/test_annotators.py, on the port
# ---------------------------------------------------------------------------

def test_sentence_segmentation_abbreviation_aware():
    cas = AnnotatorPipeline([SentenceAnnotator()]).process(
        "Dr. Smith arrived. He met Mrs. Jones at 5 p.m. sharp! Was he "
        "late? No.")
    sents = cas.sentences()
    assert sents[0] == "Dr. Smith arrived."
    assert sents[1].startswith("He met Mrs. Jones")
    assert "Was he late?" in sents
    assert sents[-1] == "No."


def test_token_annotations_align_with_text():
    cas = default_pipeline().process("The cats were running quickly!")
    toks = cas.select("token")
    assert [t.covered_text(cas.text) for t in toks] == [
        "The", "cats", "were", "running", "quickly", "!"]
    # spans index the original string
    for t in toks:
        assert cas.text[t.begin:t.end] == t.covered_text(cas.text)


def test_pos_tags():
    cas = default_pipeline().process(
        "The happy dogs chased a ball. She went to Washington to vote.")
    by_word = {t.covered_text(cas.text): t.features["pos"]
               for t in cas.select("token")}
    assert by_word["The"] == "DT"
    assert by_word["dogs"] == "NNS"
    assert by_word["chased"] == "VBD"
    assert by_word["went"] == "VBD"          # irregular past
    assert by_word["Washington"] == "NNP"    # TO + NNP stays a PP object
    assert by_word["vote"] == "VB"           # TO + common noun -> verb
    assert by_word["She"] == "PRP"


def test_porter_stemmer_canonical_vectors():
    """Canonical examples from Porter (1980)."""
    vectors = {
        "caresses": "caress", "ponies": "poni", "ties": "ti",
        "caress": "caress", "cats": "cat", "feed": "feed",
        "agreed": "agre", "plastered": "plaster", "bled": "bled",
        "motoring": "motor", "sing": "sing", "conflated": "conflat",
        "troubled": "troubl", "sized": "size", "hopping": "hop",
        "falling": "fall", "hissing": "hiss", "failing": "fail",
        "filing": "file", "happy": "happi", "sky": "sky",
        "relational": "relat", "conditional": "condit",
        "rational": "ration", "valenci": "valenc", "digitizer": "digit",
        "triplicate": "triplic", "formative": "form", "formalize": "formal",
        "electricity": "electr", "hopefulness": "hope",
        "goodness": "good", "revival": "reviv", "allowance": "allow",
        "inference": "infer", "airliner": "airlin", "adjustable": "adjust",
        "defensible": "defens", "replacement": "replac",
        "adjustment": "adjust", "dependent": "depend", "adoption": "adopt",
        "homologou": "homolog", "communism": "commun", "activate": "activ",
        "angularity": "angular", "effective": "effect", "probate": "probat",
        "rate": "rate", "controlling": "control", "rolling": "roll",
    }
    for word, want in vectors.items():
        assert porter_stem(word) == want, (word, porter_stem(word), want)


def test_lemmatizer_irregulars_and_rules():
    assert lemmatize("went") == "go"
    assert lemmatize("children") == "child"
    assert lemmatize("studies", "NNS") == "study"
    assert lemmatize("stopped", "VBD") == "stop"
    assert lemmatize("running", "VBG") == "run"
    assert lemmatize("making", "VBG") == "make"
    assert lemmatize("boxes", "NNS") == "box"
    assert lemmatize("cats") == "cat"


def test_stem_and_lemma_annotators_fill_features():
    cas = default_pipeline().process("The ponies were running.")
    feats = {t.covered_text(cas.text): t.features
             for t in cas.select("token")}
    assert feats["ponies"]["stem"] == "poni"
    assert feats["ponies"]["lemma"] == "pony"
    assert feats["running"]["lemma"] == "run"


def test_pos_tokenizer_factory_filters_and_lemmatizes():
    tf = PosTokenizerFactory(["NN"], lemmatized=True)
    toks = tf.create("The cats chased the mice in two gardens.").get_tokens()
    assert "cat" in toks and "garden" in toks
    assert "chased" not in toks and "the" not in toks
    surface = PosTokenizerFactory(["VB"]).create(
        "The cats chased the mice.").get_tokens()
    assert surface == ["chased"]


def test_annotator_sentence_iterator_and_stemming_preprocessor():
    it = AnnotatorSentenceIterator(
        ["First doc. It has two sentences.", "Second doc here!"])
    assert list(it) == ["First doc.", "It has two sentences.",
                       "Second doc here!"]
    assert StemmingPreprocessor().pre_process("Running!") == "run"
    # composes with SequenceVectors' tokenizer-factory seam
    from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
    f = DefaultTokenizerFactory(preprocessor=StemmingPreprocessor())
    assert f.create("Ponies running").get_tokens() == ["poni", "run"]


def test_pos_accuracy_floor():
    """Behavioral quality (VERDICT r4 #6): tagging accuracy on a
    committed 150-sentence hand-tagged gold fixture must stay >= 0.93.
    The gold uses CORRECT Penn tags (including VBP/VBN the baseline
    tagger cannot produce), so the floor absorbs those honestly;
    measured 0.97 when pinned."""
    import os
    fx = os.path.join(os.path.dirname(__file__), "fixtures", "pos_gold.txt")
    pipe = default_pipeline()
    tot = cor = 0
    for line in open(fx, encoding="utf-8"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        pairs = [t.rsplit("_", 1) for t in line.split()]
        words = [w for w, _ in pairs]
        text = " ".join(words)
        toks = pipe.process(text).select("token")
        # the fixture is written to the TokenizerAnnotator's tokenization
        assert [t.covered_text(text) for t in toks] == words, text
        for (w, g), t in zip(pairs, toks):
            tot += 1
            cor += t.features.get("pos") == g
    assert tot > 1000, tot
    acc = cor / tot
    assert acc >= 0.93, f"POS accuracy regressed: {acc:.4f} ({cor}/{tot})"


def test_modal_plus_have_do_is_base_form():
    """'will have' / 'can do': tensed lexicon tags drop to VB after MD."""
    cas = default_pipeline().process("She will have lunch. They can do it.")
    tags = {t.covered_text(cas.text): t.features["pos"]
            for t in cas.select("token")}
    assert tags["have"] == "VB" and tags["do"] == "VB"


# ---------------------------------------------------------------------------
# tests/test_treeparser.py, on the port
# ---------------------------------------------------------------------------

def test_parse_chunks_np_vp_pp():
    parser = TreeParser()
    (tree,) = parser.trees_for("The big dog chased the cat in the garden.")
    assert tree.label == "S"
    labels = [c.label for c in tree.children]
    assert labels[0] == "NP"          # the big dog
    assert "VP" in labels             # chased
    assert "PP" in labels             # in the garden
    assert tree.tokens() == ["The", "big", "dog", "chased", "the",
                             "cat", "in", "the", "garden"]


def test_penn_round_trip():
    parser = TreeParser()
    (tree,) = parser.trees_for("She quickly read two books.")
    penn = tree.to_penn()
    back = Tree.from_penn(penn)
    assert back.to_penn() == penn
    assert back.tokens() == tree.tokens()


def test_binarize_preserves_leaves_and_arity():
    parser = TreeParser()
    (tree,) = parser.trees_for(
        "The quick brown fox jumps over the lazy dog.")
    btree = BinarizeTreeTransformer().transform(tree)
    assert btree.tokens() == tree.tokens()
    for node in btree.preorder():
        assert len(node.children) <= 2, node.to_penn()


def test_collapse_unaries():
    t = Tree.from_penn("(S (NP (NP (NN dog))) (VP (VBD ran)))")
    c = CollapseUnaries().transform(t)
    # the NP->NP unary chain collapsed; the leaf-preterminal survives
    np_node = c.children[0]
    assert np_node.label == "NP"
    assert np_node.children[0].is_leaf()
    assert c.tokens() == ["dog", "ran"]


def test_head_word_finder():
    parser = TreeParser()
    (tree,) = parser.trees_for("The big dog chased the cat.")
    HeadWordFinder().annotate(tree)
    np_node = tree.children[0]
    assert np_node.label == "NP" and np_node.head_word == "dog"
    vp = [c for c in tree.children if c.label == "VP"][0]
    assert vp.head_word == "chased"
    assert tree.head_word is not None


def test_tree_iterator_binarizes():
    trees = list(TreeIterator(["One dog ran. Two cats sat."]))
    assert len(trees) == 2
    for t in trees:
        for node in t.preorder():
            assert len(node.children) <= 2


def test_vectorizer_composes_bottom_up():
    rng = np.random.default_rng(3)
    vocab = {}

    def lookup(tok):
        key = tok.lower()
        if key not in vocab:
            vocab[key] = rng.normal(size=8).astype(np.float32)
        return vocab[key]

    tv = TreeVectorizer(lookup, dim=8, seed=1, device="cpu")
    (tree,) = tv.vectorize("The dog chased the cat.")
    for node in tree.preorder():
        assert node.vector is not None and node.vector.shape == (8,)
        assert np.isfinite(node.vector).all()
    # root vector composed (not any single leaf's)
    leaf_vecs = [l.vector for l in tree.leaves()]
    assert not any(np.allclose(tree.vector, v) for v in leaf_vecs)
    # internal node values bounded by tanh
    assert np.abs(tree.vector).max() <= 1.0
    assert tree.head_word is not None  # heads annotated en route


def test_review_fixes_value_preserved_and_arity_guard():
    """Review r4: unary collapse keeps a chain node's token value, and
    the vectorizer refuses non-binarized arity instead of silently
    composing only two children."""
    import pytest

    t = Tree.from_penn("(X foo (Y (A a) (B b)))")
    wrapped = Tree("S", children=[Tree("X", children=[t])])
    c = CollapseUnaries().transform(wrapped)
    assert "foo" in [n.value for n in c.preorder() if n.value]

    tv = TreeVectorizer(lambda tok: np.ones(4, np.float32), dim=4,
                        device="cpu")
    wide = Tree("S", children=[Tree("NN", value=w) for w in "a b c".split()])
    with pytest.raises(ValueError, match="binarize"):
        tv.vectorize_tree(wide)


def test_mixed_node_round_trip_and_head_through_binarization():
    """Review r4 round 2: mixed (value+children) nodes serialize
    losslessly; the sentence head survives binarization; mixed-node
    tokens enter the vector composition."""
    t = Tree.from_penn("(X foo (Y (A a) (B b)))")
    assert Tree.from_penn(t.to_penn()).to_penn() == t.to_penn()
    assert "foo" in t.to_penn()

    parser = TreeParser()
    (tree,) = parser.trees_for("The big dog chased the cat.")
    btree = BinarizeTreeTransformer().transform(tree)
    HeadWordFinder().annotate(btree)
    assert btree.head_word == "chased"

    tv = TreeVectorizer(lambda tok: np.full(4, 1.0 if tok == "foo"
                                            else 0.25, np.float32), dim=4,
                        device="cpu")
    mixed = Tree.from_penn("(X foo (Y y))")
    plain = Tree.from_penn("(X (Y y))")
    tv.vectorize_tree(mixed)
    tv.vectorize_tree(plain)
    assert not np.allclose(mixed.vector, plain.vector)


# ---------------------------------------------------------------------------
# tests/test_sentiment.py, on the port
# ---------------------------------------------------------------------------

def test_word_scores_and_stem_fallback():
    sa = SentimentAnalyzer()
    assert sa.word_score("excellent") > 0
    assert sa.word_score("terrible") < 0
    assert sa.word_score("table") == 0.0
    # inflected form resolves through the Porter stem
    assert sa.word_score("enjoying") > 0
    assert sa.word_score("crashing") < 0


def test_classify_documents():
    sa = SentimentAnalyzer()
    assert sa.classify("This movie was wonderful and the cast was "
                       "brilliant.") == "positive"
    assert sa.classify("An awful, boring film with terrible acting."
                       ) == "negative"
    assert sa.classify("The train departs at noon.") == "neutral"


def test_negation_flips_and_intensity_weights():
    sa = SentimentAnalyzer()
    pos = sa.score("the food was good".split())
    neg = sa.score("the food was not good".split())
    assert pos > 0 > neg
    strong = sa.score("the food was very good".split())
    weak = sa.score("the food was slightly good".split())
    assert strong > pos > weak > 0
    # double negation cancels
    dd = sa.score("it is not without charming moments".split())
    assert dd > 0


def test_extra_lexicon_override():
    sa = SentimentAnalyzer(extra_lexicon={"sick": 1.0})  # slang flip
    assert sa.word_score("sick") > 0


def test_contractions_negate():
    """Review r4: the tokenizer keeps contractions whole, so wasn't/don't
    must negate directly."""
    sa = SentimentAnalyzer()
    assert sa.classify("The movie wasn't good.") == "negative"
    assert sa.classify("I don't like this film.") == "negative"
    # 'barely' diminishes OR negates, not both: weakly positive stays >= 0
    assert sa.score("the food was barely good".split()) <= 0  # negator
    assert "barely" not in __import__(
        "deeplearning4j_tpu_torch.nlp.sentiment", fromlist=["x"])._DIMINISHERS


def test_negation_does_not_cross_sentence_boundary():
    """Review r4: a negator in the previous sentence must not flip the
    next sentence's words."""
    sa = SentimentAnalyzer()
    assert sa.classify("The movie was not bad. Amazing!") == "positive"


def test_sentiment_accuracy_floor():
    """Behavioral quality (VERDICT r4 #6): classification accuracy on a
    committed 80-snippet labeled fixture (neutral counts as wrong) must
    stay >= 0.90; measured 1.00 when pinned."""
    import os
    fx = os.path.join(os.path.dirname(__file__), "fixtures",
                      "sentiment_gold.txt")
    sa = SentimentAnalyzer()
    tot = cor = 0
    for line in open(fx, encoding="utf-8"):
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        label, text = line.split("\t", 1)
        want = "positive" if label == "pos" else "negative"
        tot += 1
        cor += sa.classify(text) == want
    assert tot >= 80, tot
    acc = cor / tot
    assert acc >= 0.90, f"sentiment accuracy regressed: {acc:.4f} ({cor}/{tot})"


def test_resolver_noun_not_flipped():
    """'The repair was terrible' is negative — resolver flipping is
    restricted to past-form verbs so noun uses can't invert polarity."""
    sa = SentimentAnalyzer()
    assert sa.classify("The repair was terrible.") == "negative"
    assert sa.classify("The update fixed all my problems.") == "positive"


def test_ly_morphological_expansion():
    sa = SentimentAnalyzer()
    assert sa.word_score("horribly") < 0
    assert sa.word_score("terribly") < 0
    assert sa.word_score("gently") > 0
    assert sa.word_score("beautifully") > 0
