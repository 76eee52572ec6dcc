"""The port's token-level serving engine (``deeplearning4j_tpu_torch.keras.
generation``) on the CPU: one test for each engine case of
``tests/test_generation.py``, held to the same contract.

(a) decode parity — prefill + incremental decode reproduces full-forward
    greedy decoding, and BATCHED decode gives each request its SINGLETON
    tokens, with requests joining mid-flight of others;
(b) compile discipline — one step runner per (kind, bucket), a second
    wave of identical bucket shapes adds none, a ``fit_batch`` between
    waves invalidates none, and the cross-model ``CompileCache`` keeps
    its entry and byte budgets;
(c) priority classes — an ``interactive`` arrival preempts the oldest
    ``bulk`` row;
(d) chaos — ``poison_decode`` and ``corrupt_page_table`` fail one row
    alone, ``evict_cache`` re-prefills, ``evict_page`` replays, a batch
    failure (before or after the step wrote into the pool) falls back to
    singletons;
(e) the KV pool — page budgets serialize admission or fail loudly, the
    pool gauge is the pool's bytes, seeded sampling, shared prefix pages;
(f) teardown — ``stop()`` joins every decode-loop thread.

Everything runs through ``GenerationScheduler.submit`` on ``gpt_tiny``
(``device="cpu"``: the runners call their steps eagerly here; the CUDA
graphs are held against the eager steps on the card, in
``tests/test_torch_cuda.py``). This file imports no JAX.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.keras.batching import (
    CompileCache, priority_insert, priority_rank, set_compile_cache,
)
from deeplearning4j_tpu_torch.keras.generation import GenerationScheduler
from deeplearning4j_tpu_torch.models.gpt import (
    gpt_tiny, greedy_generate, sample_generate,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.profiling.metrics import (
    MetricsRegistry, get_registry, set_registry,
)
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.faultinject import (
    Fault, FaultSchedule,
)
from deeplearning4j_tpu_torch.resilience.service import (
    Deadline, NonFiniteOutput, PageTableCorruption,
)

VOCAB, SEQ_LEN, MAX_NEW = 13, 16, 6


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = set_registry(MetricsRegistry())
    faultinject.clear()
    yield
    faultinject.clear()
    set_registry(prev)


def _net():
    return ComputationGraph(gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN),
                            device="cpu").init()


@pytest.fixture(scope="module")
def net():
    return _net()


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(0, VOCAB, k).tolist()
            for k in (3, 7, 2, 5, 4, 6)]


@pytest.fixture(scope="module")
def refs(net, prompts):
    return [greedy_generate(net, p, MAX_NEW) for p in prompts]


def _submit_all(sched, net, prompts, max_new=MAX_NEW, stagger_s=0.0,
                priority="interactive", deadline_s=120.0, lock=None):
    results, res_lock = {}, threading.Lock()

    def one(i):
        if stagger_s:
            time.sleep(stagger_s * (i % 3))
        try:
            r = sched.submit("m", net, lock or threading.Lock(), prompts[i],
                             max_new, Deadline(deadline_s),
                             priority=priority)
        except Exception as e:  # noqa: BLE001 — asserted by callers
            r = e
        with res_lock:
            results[i] = r

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    return results


def _assert_refs(results, refs):
    for i, r in results.items():
        assert not isinstance(r, Exception), (i, r)
        assert r["tokens"] == refs[i], (i, r["tokens"], refs[i])


# ---------------------------------------------------------------------------
# (a) decode parity
# ---------------------------------------------------------------------------

def test_greedy_generate_matches_full_forward(net, prompts):
    """The KV-cache prefill/decode path reproduces full-forward greedy
    decoding token for token."""
    eye = np.eye(VOCAB, dtype=np.float32)
    p = prompts[0]
    toks = list(p)
    for _ in range(MAX_NEW):
        out = net.output(eye[np.asarray(toks)][None]).numpy()
        toks.append(int(out[0, len(toks) - 1].argmax()))
    assert greedy_generate(net, p, MAX_NEW) == toks[len(p):]


def test_batched_decode_equals_singleton_with_churn(net, prompts, refs):
    """Six mixed-length generations through a 4-row bucket — requests
    join mid-flight of others and leave at different steps — each
    reproduces its singleton reference."""
    sched = GenerationScheduler(max_rows=4)
    try:
        _assert_refs(_submit_all(sched, net, prompts, stagger_s=0.05), refs)
        # churn really exercised multi-row decode steps
        hist = get_registry().get("serving_decode_batch_rows")
        assert hist is not None and hist.sum > hist.count
    finally:
        sched.stop()


def test_decode_rejects_non_decodable_graph():
    """A graph with a recurrent (carry) layer has no incremental-decode
    path and fails loudly at engine build."""
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("adam", learning_rate=1e-3).graph_builder()
            .add_inputs("x")
            .add_layer("lstm", LSTM(n_out=8), "x")
            .add_layer("head", RnnOutputLayer(
                n_out=4, activation="softmax", loss="mcxent"), "lstm")
            .set_outputs("head")
            .set_input_types(InputType.recurrent(4, 8)).build())
    g = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(ValueError, match="decode"):
        g.decode_fns()
    sched = GenerationScheduler(max_rows=2)
    try:
        with pytest.raises(ValueError, match="decode"):
            sched.submit("m", g, threading.Lock(), [1, 2], 2, Deadline(10))
    finally:
        sched.stop()


def test_prompt_validation(net):
    sched = GenerationScheduler(max_rows=2)
    try:
        with pytest.raises(ValueError, match="non-empty"):
            sched.submit("m", net, threading.Lock(), [], 4, Deadline(1))
        with pytest.raises(ValueError, match="out of range"):
            sched.submit("m", net, threading.Lock(), [VOCAB + 1], 4,
                         Deadline(1))
        with pytest.raises(ValueError, match="no room"):
            sched.submit("m", net, threading.Lock(),
                         list(range(2)) * (SEQ_LEN // 2), 4, Deadline(1))
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# (b) compile discipline + the cross-model cache budget
# ---------------------------------------------------------------------------

def test_zero_captures_on_identical_second_wave(net, prompts, refs):
    sched = GenerationScheduler(max_rows=4, prewarm_decode_ladder=True)
    try:
        _submit_all(sched, net, prompts)
        compiles = sched.stats()["compiles"]
        _assert_refs(_submit_all(sched, net, prompts), refs)
        assert sched.stats()["compiles"] == compiles
        # no (kind, bucket) step was ever built twice
        assert all(n == 1
                   for n in sched.stats()["bucket_compiles"].values())
        # the second IDENTICAL wave hits the full-prompt prefix registry:
        # no prefill dispatches at all, and the tokens above are still
        # the singleton references
        st = sched.stats()
        assert sum(n for k, n in st["bucket_mix"].items()
                   if k.startswith("prefill")) == 6
        assert st["prefill_steps"] == 6
        assert st["prefix_hits"] >= 6
        assert st["prefix_cache_hit_rate"] > 0
    finally:
        sched.stop()


def test_fit_batch_between_waves_serves_the_new_weights(prompts):
    """Params are read in place, not baked into a step: a ``fit_batch``
    between two waves builds no step again, and the second wave's tokens
    are the singleton references ON THE NEW WEIGHTS (which changed them).
    The second wave's prompts are new ones: the full-prompt registry
    keeps what earlier prefills computed, under the weights of then, as
    the JAX engine's does (ROADMAP C9)."""
    net = ComputationGraph(gpt_tiny(vocab_size=VOCAB, seq_len=SEQ_LEN,
                                    learning_rate=0.05), device="cpu").init()
    shifted = [[(t + 1) % VOCAB for t in p] for p in prompts[:3]]
    old_refs = [greedy_generate(net, p, MAX_NEW) for p in shifted]
    sched = GenerationScheduler(max_rows=4, prewarm_decode_ladder=True)
    try:
        _submit_all(sched, net, prompts[:3])
        compiles = sched.stats()["compiles"]
        rng = np.random.default_rng(5)
        tok = rng.integers(0, VOCAB, (4, SEQ_LEN + 1))
        eye = np.eye(VOCAB, dtype=np.float32)
        for _ in range(3):
            net.fit_batch(DataSet(eye[tok[:, :-1]], eye[tok[:, 1:]]))
        new_refs = [greedy_generate(net, p, MAX_NEW) for p in shifted]
        assert new_refs != old_refs          # the update moved the tokens
        _assert_refs(_submit_all(sched, net, shifted), new_refs)
        assert sched.stats()["compiles"] == compiles
    finally:
        sched.stop()


@pytest.mark.parametrize("case", ["lru", "bytes", "evict_model"])
def test_compile_cache_budget(case):
    """The cross-model cache's budgets: LRU past ``max_entries`` (with a
    counter), LRU past ``max_bytes`` (a single oversize entry stays),
    and ``evict_model`` scoped to one owner's one model."""
    if case == "lru":
        cache = CompileCache(max_entries=3)
        for i in range(5):
            cache.put((1, f"m{i}", "decode", 2), object(), nbytes=10)
        assert cache.stats()["entries"] == 3
        assert cache.get((1, "m0", "decode", 2)) is None   # LRU evicted
        assert cache.get((1, "m4", "decode", 2)) is not None
        assert get_registry().get(
            "serving_compile_cache_evictions_total").value == 2
    elif case == "bytes":
        cache = CompileCache(max_entries=100, max_bytes=100)
        cache.put(("a",), object(), nbytes=60)
        cache.put(("b",), object(), nbytes=60)   # 120 > 100: evict "a"
        assert cache.get(("a",)) is None
        assert cache.get(("b",)) is not None
        cache.put(("c",), object(), nbytes=500)
        assert cache.get(("c",)) is not None
    else:
        cache = CompileCache(max_entries=10)
        cache.put((1, "a", "decode", 2), object())
        cache.put((1, "b", "decode", 2), object())
        cache.put((2, "a", "decode", 2), object())
        cache.evict_model(1, "a")
        assert cache.get((1, "a", "decode", 2)) is None
        assert cache.get((1, "b", "decode", 2)) is not None
        assert cache.get((2, "a", "decode", 2)) is not None


def test_generation_uses_budgeted_cache_and_prewarms(net, prompts):
    """A second model key on the same scheduler prewarms from the
    OBSERVED bucket mix of the first, and every step runner lives in the
    shared budgeted cache."""
    cache = CompileCache(max_entries=64)
    prev = set_compile_cache(cache)
    try:
        sched = GenerationScheduler(max_rows=4)
        try:
            _submit_all(sched, net, prompts[:2])
            n_before = get_registry().get("serving_prewarmed_buckets_total")
            assert n_before is None or n_before.value == 0
            net2 = _net()
            r = sched.submit("m2", net2, threading.Lock(), prompts[0], 2,
                             Deadline(120))
            assert r["tokens"] == greedy_generate(net2, prompts[0], 2)
            prewarmed = get_registry().get("serving_prewarmed_buckets_total")
            assert prewarmed is not None and prewarmed.value >= 1
            assert any(k[1] == "m2" for k in cache.keys())
        finally:
            sched.stop()
        assert cache.stats()["entries"] == 0   # stop() released its slice
    finally:
        set_compile_cache(prev)


# ---------------------------------------------------------------------------
# (c) priority classes
# ---------------------------------------------------------------------------

def test_priority_queue_ordering():
    """The shared insert discipline: interactive ahead of every queued
    bulk entry, FIFO within a class; ``front_of_class`` puts a requeued
    victim first within its own class."""
    Item = collections.namedtuple("Item", "name priority")
    queue = collections.deque()
    b1, b2 = Item("b1", priority_rank("bulk")), Item("b2", 1)
    i1, i2 = Item("i1", priority_rank("interactive")), Item("i2", 0)
    for it in (b1, i1, b2, i2):
        priority_insert(queue, it)
    assert [q.name for q in queue] == ["i1", "i2", "b1", "b2"]
    priority_insert(queue, Item("b0", 1), front_of_class=True)
    assert [q.name for q in queue] == ["i1", "i2", "b0", "b1", "b2"]
    with pytest.raises(ValueError, match="priority"):
        priority_rank("urgent")


def test_interactive_preempts_bulk_under_pressure(net, prompts, refs):
    """Bucket saturated by bulk generations: an interactive arrival
    evicts the oldest bulk row (ring order), completes before bulk work
    queued ahead of it, and every evicted victim re-prefills to its exact
    reference tokens."""
    sched = GenerationScheduler(max_rows=2)
    try:
        done = {}
        lock = threading.Lock()

        def gen(tag, idx, mx, prio):
            r = sched.submit("m", net, threading.Lock(), prompts[idx], mx,
                             Deadline(120), priority=prio)
            with lock:
                done[tag] = (r, time.monotonic())

        bulk = [threading.Thread(
            target=gen, args=(f"b{i}", i % len(prompts), 9, "bulk"),
            daemon=True) for i in range(16)]
        for t in bulk:
            t.start()
        # submit the interactive only once a bulk BACKLOG provably exists
        t_end = time.monotonic() + 30.0
        while time.monotonic() < t_end:
            with sched._cond:
                queued = len(sched._queues.get("m") or ())
            eng = sched._engines.get("m")
            if eng is not None and eng.active() >= 2 and queued >= 2:
                break
            time.sleep(0.002)
        ti = threading.Thread(target=gen, args=("inter", 0, 2,
                                                "interactive"), daemon=True)
        ti.start()
        ti.join(60.0)
        for t in bulk:
            t.join(120.0)
        assert "inter" in done
        t_inter = done["inter"][1]
        assert done["inter"][0]["tokens"] == refs[0][:2]
        assert sum(1 for tag, (_, ts) in done.items()
                   if tag.startswith("b") and ts > t_inter) >= 1
        refs9 = {i: greedy_generate(net, prompts[i], 9)
                 for i in range(len(prompts))}
        for tag, (r, _) in done.items():
            if tag.startswith("b"):
                assert r["tokens"] == refs9[int(tag[1:]) % len(prompts)]
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# (d) chaos kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poison_decode", "corrupt_page_table"])
def test_chaos_fails_one_row_alone(net, prompts, refs, kind):
    """``poison_decode`` NaN-poisons the first request's third step: the
    per-row sentinel fails it MID-STREAM; ``corrupt_page_table`` scribbles
    an out-of-pool page id into the oldest row's write slot: host-side
    validation fails that row with ``PAGE_TABLE`` before any step reads
    it. Either way the batchmate's stream is its singleton reference."""
    sched = GenerationScheduler(max_rows=4)
    try:
        fault = (Fault("poison_decode", at_call=1, step=3)
                 if kind == "poison_decode"
                 else Fault("corrupt_page_table", at_call=2))
        faultinject.set_schedule(FaultSchedule([fault]))
        res = {}

        def go(i, p):
            try:
                res[i] = sched.submit("m", net, threading.Lock(), p,
                                      MAX_NEW, Deadline(60))
            except Exception as e:  # noqa: BLE001
                res[i] = e

        t1 = threading.Thread(target=go, args=(1, prompts[0]), daemon=True)
        t1.start()
        time.sleep(0.15)
        t2 = threading.Thread(target=go, args=(2, prompts[1]), daemon=True)
        t2.start()
        t1.join(60.0)
        t2.join(60.0)
        faultinject.clear()
        assert res[2]["tokens"] == refs[1]     # batchmate unharmed
        if kind == "poison_decode":
            assert isinstance(res[1], NonFiniteOutput)
            assert "token" in str(res[1])      # failed MID-stream
            counter = "serving_nonfinite_outputs_total"
        else:
            assert isinstance(res[1], PageTableCorruption), res[1]
            assert res[1].code == "PAGE_TABLE"
            counter = "serving_page_table_corruptions_total"
        assert get_registry().get(counter).value == 1
    finally:
        sched.stop()


def test_evict_cache_victim_reprefills_never_garbage(net, prompts, refs):
    sched = GenerationScheduler(max_rows=4)
    try:
        faultinject.set_schedule(FaultSchedule(
            [Fault("evict_cache", at_call=2)]))
        results = _submit_all(sched, net, prompts[:2], stagger_s=0.05)
        faultinject.clear()
        _assert_refs(results, refs)
        assert sum(r["reprefills"] for r in results.values()) >= 1
        assert get_registry().get("serving_kv_evictions_total").value >= 1
    finally:
        sched.stop()


def test_evict_page_replays_exactly(net, prompts):
    """Chaos drops ONE cold page from the oldest row mid-decode: the
    victim rolls back to the page boundary, REPLAYS the lost span through
    normal decode steps (no re-prefill, emission suppressed) and still
    emits its exact greedy reference; the batchmate never notices."""
    max_new = 10
    refs10 = [greedy_generate(net, p, max_new)
              for p in (prompts[2], prompts[3])]
    sched = GenerationScheduler(max_rows=4)
    try:
        # by iteration 8 the oldest row (prompt len 2) has written past
        # page 1 (pos >= 10 > 8), so slot 1 is cold and droppable
        faultinject.set_schedule(FaultSchedule(
            [Fault("evict_page", at_call=8)]))
        results = _submit_all(sched, net, [prompts[2], prompts[3]],
                              max_new=max_new, stagger_s=0.05)
        faultinject.clear()
        _assert_refs(results, refs10)
        evictions = get_registry().get("serving_kv_page_evictions_total")
        assert evictions is not None and evictions.value >= 1
        assert all(r["reprefills"] == 0 for r in results.values())
    finally:
        sched.stop()


def _poison_multirow_buckets(sched, runner):
    for rows in (2, 4):
        sched._compiled.put((sched._cache_owner, "m", "decode", rows),
                            runner)


def test_batch_decode_failure_falls_back_to_singletons(net, prompts, refs):
    """A batch-level decode failure re-runs each live row ALONE before
    anything surfaces."""
    sched = GenerationScheduler(max_rows=4)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected decode-batch failure")

        _poison_multirow_buckets(sched, boom)
        _assert_refs(_submit_all(sched, net, prompts[:3]), refs)
        fallbacks = get_registry().get("serving_decode_fallbacks_total")
        assert fallbacks is not None and fallbacks.value >= 1
    finally:
        sched.stop()


def test_decode_failure_after_pool_write_still_gives_reference_tokens(
        net, prompts, refs):
    """The counterpart of the JAX engine's consumed-donated-pool case:
    a multi-row step runs (its scatter writes every row's new K/V into
    the pool, in place), then overwrites those write slots with garbage
    and raises. The singleton fallback re-runs each row on the same pool
    — each re-run writes its slot again before reading it — so every
    request still gets its reference tokens, with no re-prefill."""
    sched = GenerationScheduler(max_rows=4)
    pl = net.kv_page_len()
    step = net.paged_decode_fn(pl)
    fired = []

    def boom_once(params, states, pool, x, pos, tbl):
        fired.append(True)
        pos_t, tbl_t = torch.from_numpy(pos), torch.from_numpy(tbl)
        step(params, states, pool, torch.from_numpy(x), pos_t, tbl_t)
        rows = torch.arange(len(pos))
        for kv in pool.values():
            for v in kv.values():
                v[tbl_t[rows, pos_t // pl], :, pos_t % pl, :] = 7.0
        raise RuntimeError("runtime fault after the step's scatter")

    real_get = sched._compiled.get

    def patched_get(key):
        v = real_get(key)
        return None if (v is boom_once and fired) else v

    try:
        _poison_multirow_buckets(sched, boom_once)
        sched._compiled.get = patched_get
        results = _submit_all(sched, net, prompts[:3])
        _assert_refs(results, refs)
        assert fired, "multi-row decode never hit the failing step"
        assert all(r["reprefills"] == 0 for r in results.values())
        assert get_registry().get(
            "serving_decode_fallbacks_total").value >= 1
    finally:
        sched._compiled.get = real_get
        sched.stop()


# ---------------------------------------------------------------------------
# (e) the KV page pool
# ---------------------------------------------------------------------------

def test_kv_cache_budget_serializes_admission(net, prompts, refs):
    """A pool budget of three page GROUPS (page_len 4 => at most three
    resident pages — LESS than one whole 16-token row): admission and
    decode serialize through page pressure, and every generation still
    matches its reference. A request whose worst-case chain could NEVER
    fit fails loudly instead of queueing forever."""
    pgb = net.kv_page_group_bytes(net.kv_page_len())
    sched = GenerationScheduler(max_rows=4, cache_budget_bytes=3 * pgb)
    try:
        _assert_refs(_submit_all(sched, net, prompts[:3], priority="bulk"),
                     refs)
        eng = sched._engines["m"]
        assert eng.usable_pages == 3           # the budget cap held
        assert len(eng.free_pages) >= 2        # pages released at idle
        with pytest.raises(ValueError, match="KV pages"):
            # 7 prompt tokens + 9 new needs 4 pages
            sched.submit("m", net, threading.Lock(), list(prompts[1]), 9,
                         Deadline(10), priority="bulk")
    finally:
        sched.stop()


def test_kv_cache_budget_too_small_fails_loudly(net):
    sched = GenerationScheduler(max_rows=2, cache_budget_bytes=8)
    try:
        with pytest.raises(ValueError, match="cannot hold"):
            sched.submit("m", net, threading.Lock(), [1, 2], 2,
                         Deadline(10))
    finally:
        sched.stop()


def test_live_engine_pool_matches_its_gauge(net, prompts, refs):
    """The pool holds max_rows full rows of pages plus scratch page 0,
    its bytes are the page groups' (one page group = a 1-row cache of
    page_len positions), and the published gauge is those bytes."""
    sched = GenerationScheduler(max_rows=4)
    try:
        _assert_refs(_submit_all(sched, net, prompts[:2]), refs)
        eng = sched._engines["m"]
        pl = net.kv_page_len()
        assert pl == 4 and eng.pages_per_row == SEQ_LEN // pl
        assert eng.usable_pages == 4 * eng.pages_per_row
        assert net.decode_cache_bytes(4) == \
            eng.usable_pages * eng.page_group_bytes
        assert eng.pool_bytes == (eng.usable_pages + 1) * \
            eng.page_group_bytes
        assert sum(v.numel() * v.element_size()
                   for kv in eng.pool.values()
                   for v in kv.values()) == eng.pool_bytes
        gauge = get_registry().get("serving_kv_cache_bytes")
        assert gauge is not None and gauge.value == eng.pool_bytes
    finally:
        sched.stop()


def test_seeded_sampling_reproducible_and_matches_singleton(net, prompts):
    """Temperature sampling is seeded and reproducible: the batched
    engine's sampled stream equals the singleton ``sample_generate``
    reference, through the cold path and the registry-hit path;
    temperature 0 stays greedy; bad configs fail loudly."""
    temp, seeds = 0.8, [5, 11, 23]
    srefs = [sample_generate(net, prompts[i], MAX_NEW, temp, seeds[i])
             for i in range(3)]
    sched = GenerationScheduler(max_rows=4)
    try:
        results, lock = {}, threading.Lock()

        def one(i):
            r = sched.submit("m", net, threading.Lock(), prompts[i],
                             MAX_NEW, Deadline(120),
                             sampling={"temperature": temp,
                                       "seed": seeds[i]})
            with lock:
                results[i] = r
        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        for i in range(3):
            assert results[i]["tokens"] == srefs[i], (
                i, results[i]["tokens"], srefs[i])
        again = sched.submit("m", net, threading.Lock(), prompts[0],
                             MAX_NEW, Deadline(120),
                             sampling={"temperature": temp,
                                       "seed": seeds[0]})
        assert again["tokens"] == srefs[0]
        zero = sched.submit("m", net, threading.Lock(), prompts[1],
                            MAX_NEW, Deadline(120),
                            sampling={"temperature": 0.0, "seed": 99})
        assert zero["tokens"] == greedy_generate(net, prompts[1], MAX_NEW)
        with pytest.raises(ValueError, match="sampling"):
            sched.submit("m", net, threading.Lock(), prompts[0], 2,
                         Deadline(10), sampling="hot")
        with pytest.raises(ValueError, match="temperature"):
            sched.submit("m", net, threading.Lock(), prompts[0], 2,
                         Deadline(10),
                         sampling={"temperature": -1.0, "seed": 0})
    finally:
        sched.stop()


def test_shared_prefix_pages_deduped_and_refcounted(net):
    """Two DIFFERENT prompts sharing a page-aligned 8-token prefix: the
    second admission maps the first's prefix pages instead of rewriting
    them (refcount > 1), and both streams equal their singleton
    references."""
    rng = np.random.default_rng(77)
    common = rng.integers(0, VOCAB, 8).tolist()
    a, b = common + [1], common + [2, 3]
    ref_a = greedy_generate(net, a, MAX_NEW)
    ref_b = greedy_generate(net, b, MAX_NEW)
    sched = GenerationScheduler(max_rows=4)
    try:
        ra = sched.submit("m", net, threading.Lock(), a, MAX_NEW,
                          Deadline(120))
        eng = sched._engines["m"]
        pl = eng.page_len
        prefix_pids = [eng.prefix_pages[(16, tuple(common[:(j + 1) * pl]))]
                       for j in range(2)]
        rb = sched.submit("m", net, threading.Lock(), b, MAX_NEW,
                          Deadline(120))
        assert ra["tokens"] == ref_a
        assert rb["tokens"] == ref_b
        assert sched.stats()["kv_pages_shared"] >= 2
        # the SAME physical pages, held by both prompts' registry entries
        assert [eng.prefix_pages[(16, tuple(common[:(j + 1) * pl]))]
                for j in range(2)] == prefix_pids
        assert all(eng.page_ref[pid] == 2 for pid in prefix_pids)
    finally:
        sched.stop()


# ---------------------------------------------------------------------------
# (f) teardown
# ---------------------------------------------------------------------------

def _settled(baseline, timeout_s=8.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        leaked = set(threading.enumerate()) - baseline
        if not leaked:
            return []
        time.sleep(0.02)
    return [t.name for t in leaked]


def test_stop_joins_every_decode_loop_thread(net, prompts, refs):
    """Two model keys, two decode loops: after ``stop()`` the set of live
    threads is back to the baseline, and a submit after stop is refused."""
    from deeplearning4j_tpu_torch.resilience.service import DrainingError
    base = set(threading.enumerate())
    sched = GenerationScheduler(max_rows=2, idle_thread_s=60.0)
    r1 = sched.submit("m", net, threading.Lock(), prompts[0], 2,
                      Deadline(60))
    r2 = sched.submit("m2", net, threading.Lock(), prompts[1], 2,
                      Deadline(60))
    assert r1["tokens"] == refs[0][:2] and r2["tokens"] == refs[1][:2]
    loops = [t for t in threading.enumerate()
             if t.name.startswith("gen-decode-") and t not in base]
    assert len(loops) == 2
    sched.stop()
    assert not any(t.is_alive() for t in loops)
    assert _settled(base) == []
    with pytest.raises(DrainingError):
        sched.submit("m", net, threading.Lock(), prompts[0], 2,
                     Deadline(60))
