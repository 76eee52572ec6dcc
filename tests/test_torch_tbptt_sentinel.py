"""The port's tBPTT ``fit_batch`` under a ``DivergenceSentinel`` against
the JAX package's, on the CPU (ROADMAP C37).

Both packages hand each window's flag to the sentinel between windows,
so under ``raise`` or ``rollback`` at a lag below the window count the
call stops at the bad window and the later windows never run. The
char-RNN of the shardcheck cases (``char_rnn_lstm(16, 8, 2)``, B 4, T 120
in windows of 50: three windows) carries the JAX net's weights
(``convert.params_from_jax``); a NaN is planted in window 1. For each
policy and lag: the step the error names (or none), ``iteration_count``,
the params and the updater state after the call (parameters at the
char-RNN training parity of ``test_torch_multilayer_train.py``, the Adam
moments at the fused LSTM's gradient tolerance, the count exactly), the
skip counter and the listeners' ``iteration_done`` calls.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.char_rnn import char_rnn_lstm as jchar_rnn
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.resilience import sentinel as jsentinel

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.resilience import sentinel as tsentinel

V, HIDDEN, LAYERS = 16, 8, 2
B, T = 4, 120                 # three windows of 50, 50 and 20
BAD_AT = (0, 60, 3)           # (row, time, feature): window 1 of 3
#: params after the call: the char-RNN training parity (relative 1e-5,
#: an absolute floor for entries near zero)
P_RTOL, P_ATOL = 1e-5, 1e-6
#: the Adam moments: the fused LSTM's gradient tolerance
M_TOL = 2e-4

CASES = [("raise", 0), ("raise", 1), ("rollback", 0), ("skip_batch", 0)]


class _Calls:
    """A listener of either package that keeps each ``iteration_done``
    call's iteration and score."""

    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, score):
        self.calls.append((int(iteration), float(score)))


def _batch():
    r = np.random.default_rng(3)
    eye = np.eye(V, dtype=np.float32)
    feats = eye[r.integers(0, V, (B, T))]
    labels = eye[r.integers(0, V, (B, T))]
    feats[BAD_AT] = np.nan
    return feats, labels


def _nets(policy, lag):
    jnet = JNet(jchar_rnn(V, hidden=HIDDEN, layers=LAYERS)).init()
    conf = char_rnn_lstm(V, hidden=HIDDEN, layers=LAYERS)
    tnet = MultiLayerNetwork(conf, device="cpu").init(
        convert.params_from_jax(conf, jax.tree.map(np.asarray,
                                                   jnet.params)))
    jnet.set_divergence_sentinel(jsentinel.DivergenceSentinel(policy, lag))
    tnet.set_divergence_sentinel(tsentinel.DivergenceSentinel(policy, lag))
    return jnet, tnet


def _fit(net, ds, errors):
    """``fit_batch`` once; the error the sentinel raised (or None)."""
    try:
        net.fit_batch(ds)
    except errors as e:
        return type(e).__name__, e.step
    return None


@pytest.mark.parametrize("policy,lag", CASES,
                         ids=[f"{p}-lag{lag}" for p, lag in CASES])
def test_tbptt_under_a_sentinel_stops_where_the_jax_package_stops(policy,
                                                                   lag):
    feats, labels = _batch()
    jnet, tnet = _nets(policy, lag)
    jcalls, tcalls = _Calls(), _Calls()
    jnet.set_listeners(jcalls)
    tnet.set_listeners(tcalls)
    want = _fit(jnet, JDataSet(feats, labels),
                (jsentinel.DivergenceError, jsentinel.RollbackRequested))
    got = _fit(tnet, DataSet(feats, labels),
               (tsentinel.DivergenceError, tsentinel.RollbackRequested))
    assert got == want
    if policy in ("raise", "rollback"):
        # the bad window is step 2, named when the sentinel drains it:
        # at once at lag 0, after window 3 ran at lag 1
        assert got == ({"raise": "DivergenceError",
                        "rollback": "RollbackRequested"}[policy], 2)
    else:
        assert got is None
    assert tnet.iteration_count == jnet.iteration_count \
        == {0: 2, 1: 3}[lag] + (policy == "skip_batch")
    assert tnet._sentinel.skipped_batches == jnet._sentinel.skipped_batches \
        == (1 if policy == "skip_batch" else 0)
    assert [i for i, _ in tcalls.calls] == [i for i, _ in jcalls.calls]
    np.testing.assert_allclose([s for _, s in tcalls.calls],
                               [s for _, s in jcalls.calls], rtol=P_RTOL)
    ref = jax.tree.map(np.asarray, jnet.params)
    for i, (g, r) in enumerate(zip(convert.params_to_numpy(tnet.params),
                                   ref)):
        assert set(g) == set(r)
        for k in r:
            assert np.isfinite(g[k]).all()
            np.testing.assert_allclose(g[k], r[k], rtol=P_RTOL, atol=P_ATOL,
                                       err_msg=f"layer {i} {k}")
    jleaves = [np.asarray(a)
               for a in jax.tree_util.tree_leaves(jnet.opt_state)]
    tleaves = convert.opt_state_to_jax(tnet)
    assert len(tleaves) == len(jleaves)
    for g, r in zip(tleaves, jleaves):
        g = np.asarray(g).reshape(np.shape(r))
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r)      # the step count
        else:
            np.testing.assert_allclose(
                g, r, rtol=M_TOL,
                atol=M_TOL * max(1.0, float(np.abs(r).max(initial=0.0))))
