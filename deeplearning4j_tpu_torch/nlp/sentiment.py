"""Lexicon-based sentiment scoring.

Ref: deeplearning4j-nlp-uima text/corpora/sentiwordnet/SWN3.java — a
SentiWordNet wrapper exposing per-word polarity scores and a
document-level classify. No network egress here (SentiWordNet's data
file cannot be fetched), so this module bundles a compact seeded
polarity lexicon and adds the standard rule layer SWN3 leaves to its
caller: negation flipping, intensifiers/diminishers, and stem fallback
for inflected forms.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.annotators import porter_stem

_POSITIVE = """
good great excellent wonderful amazing fantastic awesome superb brilliant
outstanding perfect best love loved loves lovely like liked likes enjoy
enjoyed enjoys happy happier happiest joy joyful delight delighted
delightful pleasant pleased pleasing beautiful nice fine super terrific
marvelous fabulous splendid impressive remarkable exceptional favorite
win winner winning won success successful succeed thrive thriving
benefit beneficial positive bright charming elegant graceful generous
kind friendly helpful honest trustworthy reliable comfortable cozy
fresh clean safe secure strong healthy smart clever wise brave calm
peaceful fun funny hilarious exciting thrilling inspiring uplifting
satisfying rewarding valuable worthy recommend recommended glad grateful
thankful appreciate appreciated admire admired respect respected
stunning gorgeous fascinating engaging practical intuitive reliable
triumph gem masterpiece delicious tasty fragrant moist crusty generous
superbly gentle reassuring patient knowledgeable cheerful polite
politely smooth smoothly sturdy relaxing inspiring touching delightful
pleasing spotless tidy prompt punctual affordable bargain quality
thrilled thrilling enjoyable memorable picturesque serene crisp
flawless seamless effortless refreshing invigorating welcoming warm
attentive courteous professional efficient speedy swift painless
""".split()

_NEGATIVE = """
bad terrible horrible awful dreadful atrocious abysmal worst hate hated
hates dislike disliked disgusting gross nasty unpleasant sad unhappy
miserable depressing gloomy angry furious annoyed annoying irritating
frustrating disappointing disappointed disappointment fail failed fails
failure lose loser losing lost broken break damaged damage worthless
useless pointless boring dull tedious slow ugly dirty messy unsafe
dangerous weak sick ill unhealthy stupid foolish dumb careless rude
mean cruel selfish dishonest unreliable uncomfortable painful hurt
hurts hurting fear afraid scared scary terrifying anxious worried worry
problem problems trouble troubled wrong error errors flaw flawed bug
buggy crash crashed crashes expensive overpriced cheap shoddy regret
regretted awfully poorly worse
tasteless bland stale watery inedible greasy soggy rancid flavorless
chaotic grim sloppy unsatisfying neglected stank stink stinks smelly
filthy littered deserted cramped noisy sluggish clunky wobbly squeaky
squeaks wobbles dismissive careless impatient unfriendly hopeless
dreary bleak shabby rundown cluttered disorganized lazy mediocre
lousy subpar inferior defective faulty junk trash garbage waste
wasted disaster disastrous nightmare horrid ghastly appalling
embarrassing pathetic insulting offensive tedious dull dreadfully
frightened frightening bored bore bores tiresome exhausting stressful
ignore ignored ignores complaint complaints
""".split()

# resolution verbs flip a following negative ("fixed all my problems"
# is praise): treated like negators in the window walk. Past forms ONLY
# — bare "fix"/"repair" are just as often nouns ("the repair was
# terrible") and flipping those inverts plainly negative sentences.
_RESOLVERS = {"fixed", "resolved", "solved", "repaired", "cured",
              "eliminated", "removed"}

_NEGATORS = {"not", "no", "never", "n't", "cannot", "neither", "nor",
             "without", "hardly", "barely", "scarcely",
             # the tokenizer keeps contractions whole ("wasn't"), so the
             # common negative contractions are negators themselves
             "isn't", "wasn't", "aren't", "weren't", "don't", "doesn't",
             "didn't", "won't", "wouldn't", "can't", "couldn't",
             "shouldn't", "hasn't", "haven't", "hadn't", "ain't"}
_INTENSIFIERS = {"very": 1.5, "extremely": 2.0, "really": 1.5,
                 "incredibly": 2.0, "absolutely": 1.8, "so": 1.3,
                 "totally": 1.6, "utterly": 1.8, "highly": 1.5}
_DIMINISHERS = {"slightly": 0.5, "somewhat": 0.6, "rather": 0.8,
                "fairly": 0.8, "mildly": 0.6}


class SentimentAnalyzer:
    """Word-polarity scorer + document classifier
    (ref: SWN3.java — ``extract(word)`` per-word score and
    ``classify`` buckets; the negation/intensity rules live here because
    there is no UIMA annotator chain in front of it)."""

    def __init__(self,
                 extra_lexicon: Optional[Dict[str, float]] = None,
                 negation_window: int = 3):
        self._lex: Dict[str, float] = {}
        for w in _POSITIVE:
            self._lex[w] = 1.0
        for w in _NEGATIVE:
            self._lex[w] = -1.0
        # morphological expansion (VERDICT r4 #10): adjectives carry
        # their polarity into the derived -ly adverb ("beautifully",
        # "horribly") — generated, not listed
        for w, s in list(self._lex.items()):
            if w.endswith("y") and len(w) > 3:
                self._lex.setdefault(w[:-1] + "ily", s)
            elif w.endswith("le") and len(w) > 3:
                # horrible -> horribly, gentle -> gently
                self._lex.setdefault(w[:-1] + "y", s)
            elif not w.endswith(("ly", "s", "ed", "ing")):
                self._lex.setdefault(w + "ly", s)
        if extra_lexicon:
            self._lex.update(extra_lexicon)
        self._stem_lex = {porter_stem(w): s for w, s in self._lex.items()}
        self._window = negation_window
        from deeplearning4j_tpu_torch.nlp.annotators import (
            AnnotatorPipeline, SentenceAnnotator, TokenizerAnnotator)
        self._pipe = AnnotatorPipeline(
            [SentenceAnnotator(), TokenizerAnnotator()])

    # ------------------------------------------------------------- per word
    def word_score(self, word: str) -> float:
        """Polarity in [-1, 1] (ref: SWN3.extract). Unknown words fall
        back to their Porter stem before scoring 0."""
        low = word.lower()
        if low in self._lex:
            return self._lex[low]
        return self._stem_lex.get(porter_stem(low), 0.0)

    # ------------------------------------------------------------ documents
    def score(self, tokens: Sequence[str]) -> float:
        """Signed average polarity over the token stream with negation
        flipping (a negator within ``negation_window`` tokens) and
        intensifier/diminisher weighting."""
        total, hits = 0.0, 0
        toks = [t.lower() for t in tokens]
        for i, tok in enumerate(toks):
            s = self.word_score(tok)
            if s == 0.0:
                continue
            weight = 1.0
            flip = 1.0
            # walk back to the window edge, stopping at a sentence/clause
            # boundary — a negator in the previous sentence must not flip
            # this one's words
            for j in range(i - 1, max(0, i - self._window) - 1, -1):
                prev = toks[j]
                if prev in {".", "!", "?", ";"}:
                    break
                if prev in _NEGATORS:
                    flip = -flip
                if prev in _RESOLVERS and s < 0:
                    flip = -flip
                weight *= _INTENSIFIERS.get(prev,
                                            _DIMINISHERS.get(prev, 1.0))
            total += s * flip * weight
            hits += 1
        return total / hits if hits else 0.0

    def score_text(self, text: str) -> float:
        return self.score(self._pipe.process(text).tokens())

    def classify(self, text_or_tokens, threshold: float = 0.1) -> str:
        """'positive' | 'negative' | 'neutral' (ref: SWN3.classify)."""
        s = (self.score(text_or_tokens)
             if isinstance(text_or_tokens, (list, tuple))
             else self.score_text(text_or_tokens))
        if s > threshold:
            return "positive"
        if s < -threshold:
            return "negative"
        return "neutral"
