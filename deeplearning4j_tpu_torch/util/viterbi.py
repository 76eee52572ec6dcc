"""Viterbi decoding (the JAX package's ``util/viterbi.py``, host numpy;
ref: deeplearning4j-nn/.../util/Viterbi.java).

Two entry points:

- ``viterbi_decode(emission_logprobs, transition_logprobs)`` — general
  max-sum decoding over a lattice, vectorized over states per step.
- ``Viterbi`` — the reference's noisy-channel label smoother: observed
  labels are assumed correct with probability ``p_correct`` and states
  persist with probability ``meta_stability``; ``decode`` returns the most
  likely true label sequence (Viterbi.java:30-120 semantics).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def viterbi_decode(emission_logprobs: np.ndarray,
                   transition_logprobs: np.ndarray,
                   initial_logprobs: np.ndarray = None
                   ) -> Tuple[float, np.ndarray]:
    """Most likely state path. emission: [T, S]; transition: [S, S]
    (transition[i, j] = logp(j at t+1 | i at t)). Returns (path logprob,
    state indices [T])."""
    em = np.asarray(emission_logprobs, np.float64)
    tr = np.asarray(transition_logprobs, np.float64)
    T, S = em.shape
    if initial_logprobs is None:
        initial_logprobs = np.full(S, -math.log(S))
    delta = initial_logprobs + em[0]
    back = np.zeros((T, S), np.int64)
    for t in range(1, T):
        cand = delta[:, None] + tr          # [S_prev, S_next]
        back[t] = cand.argmax(axis=0)
        delta = cand.max(axis=0) + em[t]
    path = np.zeros(T, np.int64)
    path[-1] = int(delta.argmax())
    for t in range(T - 2, -1, -1):
        path[t] = back[t + 1][path[t + 1]]
    return float(delta.max()), path


class Viterbi:
    """Noisy-channel smoothing of a predicted label sequence."""

    def __init__(self, possible_labels: Sequence[float],
                 meta_stability: float = 0.9, p_correct: float = 0.99):
        self.possible_labels = np.asarray(possible_labels)
        self.states = len(self.possible_labels)
        self.meta_stability = meta_stability
        self.p_correct = p_correct

    def decode(self, labels: np.ndarray,
               binary_label_matrix: bool = None) -> Tuple[float, np.ndarray]:
        """labels: either a one-hot matrix [T, S] or an index vector [T].
        Returns (sequence logprob, smoothed label values)."""
        labels = np.asarray(labels)
        if binary_label_matrix is None:
            binary_label_matrix = labels.ndim == 2
        if binary_label_matrix:
            obs = labels.argmax(axis=1)
        else:
            # label VALUES -> state indices (possible_labels need not be 0..S-1)
            value_to_state = {v: i for i, v in
                              enumerate(self.possible_labels.tolist())}
            try:
                obs = np.array([value_to_state[v] for v in labels.tolist()])
            except KeyError as e:
                raise ValueError(
                    f"Label {e.args[0]!r} not in possible_labels "
                    f"{self.possible_labels.tolist()}") from None
        T = len(obs)
        S = self.states
        # emission: observed label correct w.p. p_correct
        p_wrong = (1.0 - self.p_correct) / max(S - 1, 1)
        em = np.full((T, S), math.log(p_wrong))
        em[np.arange(T), obs] = math.log(self.p_correct)
        # transition: stay w.p. meta_stability
        p_switch = (1.0 - self.meta_stability) / max(S - 1, 1)
        tr = np.full((S, S), math.log(p_switch))
        np.fill_diagonal(tr, math.log(self.meta_stability))
        logp, path = viterbi_decode(em, tr)
        return logp, self.possible_labels[path]
