#!/usr/bin/env python3
"""CBOW on the NLP smoke's synthetic corpus at several learning rates:
how far the rows share one direction, and whether the topics separate.

    python3 tools/nlp_topics.py                      # on the card
    python3 tools/nlp_topics.py --device cpu --sentences 200 --vocab 13290

Builds ``chip_smoke.nlp_corpus()`` (``--sentences`` and ``--vocab`` cut
it: the head words stay 1,290, each topic's tail takes an eighth of the
rest), trains ``Word2Vec`` CBOW at ``chip_smoke.W2V_SETTINGS`` for each
``--lr`` (and ``--negative``), and prints one JSON line a run: the mean
and largest syn0 row norm, the mean cosine within each topic's 100 most
frequent tail words (its smallest and largest over the topics) and
across topics, raw and with the mean row taken out, and the share of
same-topic words among ten nearest neighbours of 24 tail words. The
card's name and power limit are printed first when it runs there.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.nlp import Word2Vec  # noqa: E402


def cosines(vecs, topic):
    e = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True),
                          1e-12)
    sims = e @ e.T
    same = topic[:, None] == topic[None, :]
    off = ~np.eye(len(topic), dtype=bool)
    within = [float(sims[(topic[:, None] == k) & (topic[None, :] == k)
                         & off].mean()) for k in np.unique(topic)]
    return dict(within_min=min(within), within_max=max(within),
                across=float(sims[~same].mean()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--lr", type=float, nargs="+", default=[0.025, 0.05])
    ap.add_argument("--negative", type=int,
                    default=cs.W2V_SETTINGS["negative"])
    ap.add_argument("--sentences", type=int, default=cs.NLP_SENTENCES)
    ap.add_argument("--vocab", type=int, default=cs.NLP_V)
    args = ap.parse_args()
    if args.device is None:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    cs.NLP_SENTENCES, cs.NLP_V = args.sentences, args.vocab
    sents, _, _ = cs.nlp_corpus()
    n = cs.NLP_TOPIC_WORDS
    names = [f"t{k}w{r}" for k in range(cs.NLP_TOPICS) for r in range(n)]
    topic = np.repeat(np.arange(cs.NLP_TOPICS), n)
    for lr in args.lr:
        w2v = Word2Vec(**{**cs.W2V_SETTINGS, "elements_algo": "cbow",
                          "learning_rate": lr, "negative": args.negative,
                          "device": args.device})
        t0 = time.perf_counter()
        w2v.fit(sents)
        lt = w2v.lookup_table
        norms = np.linalg.norm(lt.syn0, axis=1)
        vecs = np.stack([lt.get_word_vector(w) for w in names]).astype(
            np.float64)
        near = [(k, lt.words_nearest(f"t{k}w{r}", 10))
                for k in range(cs.NLP_TOPICS) for r in (0, 5, 50)]
        print(json.dumps(dict(
            lr=lr, negative=args.negative, sentences=args.sentences,
            vocab=len(w2v.vocab), fit_seconds=time.perf_counter() - t0,
            norm_mean=float(norms.mean()), norm_max=float(norms.max()),
            raw=cosines(vecs, topic),
            centered=cosines(vecs - lt.syn0.mean(0), topic),
            nearest_same_topic=float(np.mean(
                [sum(w.startswith(f"t{k}w") for w in ws) / 10
                 for k, ws in near])))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
