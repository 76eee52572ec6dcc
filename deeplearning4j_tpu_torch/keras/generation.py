"""Token-level continuous batching for autoregressive decoders (the JAX
package's ``keras/generation.py``, on PyTorch).

The scheduling unit is the DECODE STEP. This module serves the GPT
decoder (``models/gpt.py``) iteration-level:

- **Requests join and leave the running batch every decode step.** A
  per-model decode loop owns a pow2-row bucket; an admitted request is
  prefilled (its own pow2 prompt-length bucket), its KV pages are mapped
  into the bucket, and from then on each loop iteration decodes ONE
  token for every live row. A finished (or failed) row leaves
  immediately; the bucket compacts to the next power of two.
- **One step runner per (kind, bucket)**, the port's stand-in for the
  JAX engine's AOT-compiled executables: on a CUDA model the step is
  captured once into a ``torch.cuda.CUDAGraph`` over static input
  buffers (the one-hot tokens, the lengths or positions, the page
  table) and replayed for every call; on the CPU it runs eagerly.
  Params, states and the page pool are read IN PLACE by address, so a
  ``fit_batch`` (whose updater adds in place) never invalidates a
  bucket; a runner whose tensors were replaced since its capture
  (``net.init(params=...)``) re-captures before it replays, counted as a
  compile — it never replays stale weights. Steady state runs with ZERO
  captures: a second wave of identical bucket shapes adds none. Runners
  live in the budgeted cross-model :class:`~.batching.CompileCache`.
- **KV state lives in a BLOCK-PAGED pool**: one fixed
  ``[n_pages, H, page_len, D]`` tensor pair per attention node, all
  nodes sharing ONE physical page-id space (a "page group" = the same
  slot across every node's k and v). Each decode row owns a host-side
  page table mapping logical page slots to physical pages; the paged
  step gathers the row's chain back into the exact dense
  ``[rows, H, max_len, D]`` cache shape, runs the UNCHANGED attention
  math, and scatters the one new K/V token back into the row's write
  page, in place. Physical page 0 is reserved scratch: unmapped table
  slots alias it, so a free or stalled row's scatter never lands in a
  live page (several rows may scatter into page 0 in one step, and on
  the card one of them wins arbitrarily: page 0 is only ever read at
  masked positions, and its values stay finite).
- **A failed step needs no pool rebuild.** The JAX engine donates the
  pool, and a step that dies after dispatch can consume it (every row
  then re-prefills). Here the pool is updated in place and a step
  writes nothing but each row's K/V at its write position, which the
  singleton re-run of that row writes again before anything reads it;
  so a batch-level failure, before or after its scatter, re-runs each
  live row alone on the same pool.
- **Refcounted prefix sharing.** Prompt prefixes are content-hashed at
  page granularity (key = prefill bucket + exact token prefix): a full
  page whose prefix matches one already resident is MAPPED, not
  rewritten — refcount++ and the pool write is skipped; a page frees
  only at refcount zero. A shared page is read-only by construction
  (decode writes only ever land in a row's EXCLUSIVE write page — host
  validation asserts refcount==1 on it every step). On top rides a
  full-prompt registry (LRU): an identical prompt skips prefill
  entirely — retained pages are mapped, the partial tail page restored
  from host copies, and the first token re-selected from the cached
  prefill probs.
- **Page-granular eviction under pool pressure.** When allocation fails
  the allocator walks a pressure ladder: registry LRU entries drop
  their retained refs first, then the oldest-admitted BULK row loses
  its COLDEST entirely-decode-written page — the victim rolls its
  position back to the lost page's first token and REPLAYS its own
  recorded tokens through the normal decode step (emission suppressed),
  re-deriving the lost K/V bitwise. If every live row stalls on
  allocation, the oldest row falls back to whole-ROW eviction (requeue
  + re-prefill), so progress is guaranteed. ``evict_page`` /
  ``corrupt_page_table`` chaos force these paths.
- **Seeded sampling**: ``{"sampling": {"temperature": t, "seed": s}}``
  switches a request from greedy argmax to seeded temperature sampling
  whose draw index is the tokens-generated count — the token stream is
  reproducible for a fixed seed, whatever churn, replay, or re-prefill
  the request lived through. Greedy stays the default.
- **Priority classes**: the admission queue orders ``interactive`` ahead
  of ``bulk`` (stable FIFO within a class); interactive arrivals may
  evict a whole bulk row (ring order) when row slots run out.

The nonfinite sentinel runs PER ROW per step (a poisoned request fails
alone MID-STREAM — ``poison_decode`` chaos proves it; its batchmates
keep decoding), and a batch-level decode failure re-runs each row as a
singleton before anything surfaces.

Observability: ``serving_generated_tokens_total``,
``serving_decode_steps_total``, ``serving_decode_batch_rows``
histogram, ``serving_ttft_seconds`` + ``serving_ttft_p50/p99_ms``
(time-to-first-token = admission to the prefill's first token),
``serving_kv_cache_bytes`` gauge (the resident page-pool bytes),
``serving_kv_evictions_total`` / ``serving_reprefills_total``,
``serving_kv_page_evictions_total``, ``serving_prefill_steps_total``,
``serving_prefix_cache_lookups_total`` /
``serving_prefix_cache_hits_total``,
``serving_page_table_corruptions_total``,
``serving_compile_seconds_total`` (capture time), and ``serve:prefill``
/ ``serve:decode`` tracer spans. ``stats()`` surfaces
``prefix_cache_hit_rate`` and the ``kv_pages_*`` pool occupancy.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.keras.batching import (
    CAPTURE_LOCK, CompileCache, _LatencyWindow, _signature,
    get_compile_cache, next_cache_owner, priority_insert, priority_rank,
)
from deeplearning4j_tpu_torch.profiling.flightrec import (
    record as flight_record,
)
from deeplearning4j_tpu_torch.profiling.metrics import get_registry
from deeplearning4j_tpu_torch.profiling.tracer import get_tracer
from deeplearning4j_tpu_torch.profiling.watchdog import beat as watchdog_beat
from deeplearning4j_tpu_torch.resilience import faultinject
from deeplearning4j_tpu_torch.resilience.sentinel import host_nonfinite
from deeplearning4j_tpu_torch.resilience.service import (
    Deadline, DeadlineExceeded, DrainingError, NonFiniteOutput,
    PageTableCorruption,
)
from deeplearning4j_tpu_torch.util.math_utils import next_pow_of_2

#: row-count edges for the serving_decode_batch_rows histogram
DECODE_ROWS_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def sample_token(probs, temperature: float = 0.0, seed: int = 0,
                 draw_index: int = 0) -> int:
    """Seeded temperature sampling over one probability row.
    ``temperature <= 0`` degrades to greedy argmax. The draw is
    ``default_rng([seed, draw_index]).random()`` — a COUNTER-KEYED
    stream: the i-th generated token of a request depends only on
    (seed, i), never on batching, page eviction, replay, or re-prefill
    history, so a fixed seed pins a bitwise-reproducible token stream.
    Inverse-CDF over the temperature-rescaled distribution, float64 on
    host: one deterministic code path, no accelerator variance.
    ``models/gpt.py``'s singleton ``sample_generate`` reference uses
    this same function, which is what makes batched sampling == the
    singleton stream provable token-for-token."""
    p = np.asarray(probs, np.float64).ravel()
    if temperature <= 0.0:
        return int(p.argmax())
    z = np.log(np.maximum(p, 1e-38)) / float(temperature)
    z = np.exp(z - z.max())
    z /= z.sum()
    u = np.random.default_rng([int(seed), int(draw_index)]).random()
    return int(min(np.searchsorted(np.cumsum(z), u), p.size - 1))


class StepRunner:
    """One (kind, bucket) step of a decoder, the port's stand-in for
    the JAX engine's AOT-compiled executable: ``("prefill", pow2 prompt
    length)`` or ``("decode", pow2 rows)``.

    - **On a CUDA model** the step is captured once into a
      ``torch.cuda.CUDAGraph`` over static input buffers (x, the
      lengths or positions, the page table), warmed up first on a side
      stream, with ``capture_error_mode="thread_local"`` so another
      thread's CUDA calls cannot invalidate the capture. The graph
      reads the params, the states and the page pool in place; each
      call copies the host inputs into the static buffers, replays the
      graph, and returns a host copy of the probabilities, so the next
      replay cannot overwrite what a caller holds. The prefill graph
      owns its 1-row KV cache: the caller copies out of it before it
      runs another prefill. ``nbytes`` is the device memory the graph's
      private pool took at capture. A call whose params, states or pool
      no longer live where the capture found them re-captures first
      (``on_capture`` counts it as a compile): a graph never replays
      stale weights.
    - **On the CPU** the step is called eagerly; nothing is captured.

    Calls: prefill ``runner(params, states, x, lengths)`` -> ``(probs
    [1, V], caches)``; decode ``runner(params, states, pool, x,
    positions, table)`` -> ``(probs [rows, V], pool)`` with the pool
    updated in place. Inputs are numpy arrays (x float32, the rest
    int64); probabilities come back as numpy arrays."""

    WARMUP = 2

    def __init__(self, model, kind: str, bucket: int, page_len: int,
                 pool=None, on_capture=None):
        self.kind = kind
        self.nbytes = 0
        self.on_capture = on_capture
        self.graphed = model.device.type == "cuda"
        vocab = model.decode_vocab()
        if kind == "prefill":
            self._fn = model.decode_fns()[0]
            x_shape, aux_shape = (1, bucket, vocab), (1,)
            self._new_cache = model.init_decode_cache
        else:
            self._fn = model.paged_decode_fn(page_len)
            x_shape, aux_shape = (bucket, 1, vocab), (bucket,)
            tbl_shape = (bucket, model.decode_max_len() // page_len)
        self._dtype = model.dtype
        self._graph = None
        if not self.graphed:
            return
        dev = model.device
        self._x = torch.empty(x_shape, dtype=model.dtype, device=dev)
        self._aux = torch.empty(aux_shape, dtype=torch.int64, device=dev)
        if kind == "prefill":
            self._caches = model.init_decode_cache(1)
        else:
            self._tbl = torch.empty(tbl_shape, dtype=torch.int64,
                                    device=dev)
        self.capture(model.params, model.states, pool)

    def _step(self, params, states, pool):
        if self.kind == "prefill":
            return self._fn(params, states, self._caches, self._x,
                            self._aux)[0]
        return self._fn(params, states, pool, self._x, self._aux,
                        self._tbl)[0]

    def capture(self, params, states, pool) -> None:
        """(Re-)capture the step's graph against these tensors."""
        t0 = time.perf_counter()
        with CAPTURE_LOCK:
            self._capture_locked(params, states, pool)
        if self.on_capture is not None:
            self.on_capture(time.perf_counter() - t0)

    def _capture_locked(self, params, states, pool) -> None:
        self._graph = None           # release a stale graph's pool first
        # the warm-up runs for real: inputs of a prefill length of 1, and
        # decode position 0 on table 0, keep its writes in the runner's
        # own cache or scratch page 0 (finite: an all-zero x embeds to
        # the bias and the position row). A re-capture must not write
        # the last call's rows again: their pages may belong to others
        self._x.zero_()
        self._aux.fill_(1 if self.kind == "prefill" else 0)
        if self.kind == "decode":
            self._tbl.zero_()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(self.WARMUP):
                self._step(params, states, pool)
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._out = self._step(params, states, pool)
        self._graph = graph
        self._sig = _signature(params, states, pool)
        self.nbytes = max(0, torch.cuda.memory_reserved() - reserved)

    def __call__(self, params, states, *args):
        if self.kind == "prefill":
            pool, (x, aux), table = None, args, None
        else:
            pool, x, aux, table = args
        if not self.graphed:
            xt = torch.from_numpy(np.asarray(x)).to(self._dtype)
            auxt = torch.from_numpy(np.asarray(aux, np.int64))
            if self.kind == "prefill":
                probs, caches = self._fn(params, states,
                                         self._new_cache(1), xt, auxt)
                return probs.numpy(), caches
            probs, pool = self._fn(
                params, states, pool, xt, auxt,
                torch.from_numpy(np.asarray(table, np.int64)))
            return probs.numpy(), pool
        if _signature(params, states, pool) != self._sig:
            self.capture(params, states, pool)   # tensors were replaced
        self._x.copy_(torch.from_numpy(np.asarray(x)))
        self._aux.copy_(torch.from_numpy(np.asarray(aux, np.int64)))
        if table is not None:
            self._tbl.copy_(torch.from_numpy(np.asarray(table, np.int64)))
        self._graph.replay()
        probs = self._out.cpu().numpy()
        return probs, (self._caches if self.kind == "prefill" else pool)


class _GenRequest:
    """One generation in flight: the prompt (plus any tokens already
    generated before a cache eviction), its budget, and the future the
    submitting handler thread blocks on."""

    __slots__ = ("prompt", "max_new", "priority", "deadline", "event",
                 "tokens", "error", "t0", "ttft_s", "index", "steps",
                 "reprefills", "admit_seq", "model_obj", "on_token",
                 "sampling")

    def __init__(self, prompt: np.ndarray, max_new: int, priority: int,
                 deadline: Deadline, index: int, on_token=None,
                 sampling: Optional[dict] = None):
        self.prompt = prompt
        self.on_token = on_token         # per-token stream hook
        self.sampling = sampling         # None = greedy argmax
        self.max_new = max_new
        self.priority = priority
        self.deadline = deadline
        self.event = threading.Event()
        self.tokens: List[int] = []      # generated so far
        self.error: Optional[BaseException] = None
        self.t0 = time.monotonic()
        self.ttft_s: Optional[float] = None
        self.index = index               # admission order (chaos seam)
        self.steps = 0                   # decode steps taken
        self.reprefills = 0
        self.admit_seq = -1              # ring position (eviction order)
        self.model_obj = None            # the weights my tokens came from

    def push_token(self, tok: int) -> None:
        """Append one generated token and stream it to the submitter's
        ``on_token`` hook (the gateway's partial-line writer). A hook
        failure — the client hung up mid-stream — unhooks streaming but
        never touches the generation itself: tokens keep accumulating
        and the final result (or the handler's own write failure)
        settles the request. Called only on the decode-loop thread, and
        always BEFORE ``finish()`` sets the event, so every partial is
        on the wire before the final response line."""
        self.tokens.append(tok)
        cb = self.on_token
        if cb is not None:
            try:
                cb(tok)
            except Exception:  # noqa: BLE001 — stream loss ≠ decode loss
                self.on_token = None

    def history(self) -> np.ndarray:
        """prompt + generated tokens — what a re-prefill rebuilds from."""
        if not self.tokens:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.tokens, np.int32)])

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.event.set()

    def finish(self) -> None:
        self.event.set()


class _Engine:
    """Per-model decode state: the pow2 row bucket, its KV page pool,
    and the prefill/decode step runners. All mutation happens on the
    owning scheduler's decode-loop thread; the scheduler lock only
    guards the queue handoff."""

    def __init__(self, scheduler: "GenerationScheduler", key: str,
                 model, lock: threading.Lock):
        model.decode_fns()                     # validates decodability
        self.scheduler = scheduler
        self.key = key
        self.model = model
        self.lock = lock
        self.vocab = model.decode_vocab()
        self.max_len = model.decode_max_len()
        # ---- block-paged KV pool sizing: usable pages = max_rows full
        # rows, capped by the byte budget; +1 physical page 0 reserved
        # as SCRATCH (unmapped table slots alias it).
        self.page_len = model.kv_page_len(scheduler.kv_page_len)
        self.pages_per_row = self.max_len // self.page_len
        self.page_group_bytes = model.kv_page_group_bytes(self.page_len)
        usable = scheduler.max_rows * self.pages_per_row
        budget = scheduler.cache_budget_bytes
        if budget is not None:
            usable = min(usable, budget // self.page_group_bytes)
            if usable < 1:
                raise ValueError(
                    f"cache_budget_bytes={budget} cannot hold even one "
                    f"KV page group ({self.page_group_bytes} "
                    f"bytes/page-group)")
        self.usable_pages = usable
        self.total_pages = usable + 1
        self.pool = model.init_kv_page_pool(self.total_pages,
                                            self.page_len)
        self.pool_bytes = self.total_pages * self.page_group_bytes
        # ---- page allocator state: HOST truth. ``row_pages`` is the
        # authoritative ownership map (slot -> physical page id, one
        # dict per row) mirroring every table write; validation and
        # release go through IT, never through the (derived, possibly
        # corrupted) numpy table.
        self.page_ref = [0] * self.total_pages
        self.page_ref[0] = 1               # scratch: never allocatable
        self.free_pages = list(range(1, self.total_pages))
        self.page_key: Dict[int, tuple] = {}      # pid -> prefix key
        self.prefix_pages: Dict[tuple, int] = {}  # prefix key -> pid
        #: full-prompt LRU registry: (bucket, tokens) -> retained full
        #: pages + host tail copies + prefill probs — a hit skips
        #: prefill entirely
        self.prompt_registry: "collections.OrderedDict[tuple, dict]" = \
            collections.OrderedDict()
        self.rows = 0
        self.table = np.full((0, self.pages_per_row), -1, np.int32)
        self.row_pages: List[Dict[int, int]] = []
        self.slots: List[Optional[_GenRequest]] = []
        self.tokens: List[int] = []      # next token to feed, per slot
        self.positions: List[int] = []   # next decode position, per slot
        self.prefill_lens: List[int] = []  # prefill coverage, per slot
        self.iteration = 0
        self._admit_seq = 0
        self._eye = np.eye(self.vocab, dtype=np.float32)

    # ---------------------------------------------------------- compiled
    def _compiled(self, kind: str, bucket: int):
        """The step runner for one (kind, bucket): ``("prefill", pow2
        prompt len)`` or ``("decode", pow2 rows)`` — cached in the
        budgeted cross-model cache, captured once (:class:`StepRunner`).
        The page table rides the decode step as a plain int64 gather
        index, so the pool shapes (hence the graphs) are identical for
        every row bucket and the zero-capture steady state survives the
        indirection."""
        sched = self.scheduler
        cache_key = (sched._cache_owner, self.key, kind, bucket)
        runner = sched._compiled.get(cache_key)
        if runner is not None:
            return runner
        runner = StepRunner(
            self.model, kind, bucket, self.page_len,
            pool=self.pool if kind == "decode" else None,
            on_capture=lambda s, key=self.key: sched._count_capture(
                key, kind, bucket, s))
        if not runner.graphed:
            sched._count_capture(self.key, kind, bucket, 0.0)
        with sched._cond:
            cur = sched._backends.get(self.key)
            if (cur is not None and cur[0] is self.model
                    and not sched._stopping):
                # cache only while the key still maps to THIS model
                # object — an evict (purge serializes on this cond) or
                # a swap-to-fresh-load while we captured must not get
                # a stale runner re-landed behind it — and only while
                # the scheduler lives: stop() released its slice
                sched._compiled.put(
                    cache_key, runner,
                    CompileCache.compiled_nbytes(runner))
        return runner

    def prewarm(self, mix, top: int) -> int:
        """Speculatively capture the most-observed prefill/decode
        buckets for this (fresh) engine before traffic needs them."""
        done = 0
        for (kind, bucket), _ in mix:
            if done >= top:
                break
            if self.scheduler._compiled.get(
                    (self.scheduler._cache_owner, self.key, kind,
                     bucket)) is None:
                try:
                    self._compiled(kind, bucket)
                    done += 1
                except Exception:  # noqa: BLE001 — prewarm is speculative
                    continue
        if done:
            get_registry().counter(
                "serving_prewarmed_buckets_total",
                help="buckets captured speculatively from the "
                     "observed request-size mix").inc(done)
        return done

    # ------------------------------------------------------------ prefill
    def prefill_bucket(self, n_tokens: int) -> int:
        return min(next_pow_of_2(n_tokens), self.max_len)

    def _prefill(self, req: _GenRequest):
        """Run the request's prompt (or re-prefill history) through its
        pow2 length bucket; returns (probs row ``[V]``, 1-row caches).
        On the card the caches are the prefill graph's own: the caller
        copies what it keeps out of them before the next prefill. Every
        call counts a prefill STEP — the number a prefix-cache hit
        provably keeps flat."""
        history = req.history()
        L = len(history)
        bucket = self.prefill_bucket(L)
        x = np.zeros((1, bucket, self.vocab), np.float32)
        x[0, :L] = self._eye[history]
        runner = self._compiled("prefill", bucket)
        get_registry().counter(
            "serving_prefill_steps_total",
            help="prefill steps executed (a prefix-cache hit skips "
                 "one)").inc()
        with self.scheduler._stats_lock:   # traffic mix (prewarm signal)
            self.scheduler._mix[("prefill", bucket)] += 1
            self.scheduler.prefill_steps += 1
        flight_record("serving", "prefill_dispatch", model=self.key,
                      bucket=bucket, tokens=L)
        with get_tracer().span("serve:prefill", model=self.key,
                               bucket=bucket, tokens=L):
            with self.lock:
                probs, caches = runner(
                    self.model.params, self.model.states, x,
                    np.asarray([L], np.int64))
        return probs[0], caches

    def _select(self, req: _GenRequest, probs_vec) -> int:
        """Next-token selection for one row: greedy argmax unless the
        request carries a sampling config — then seeded temperature
        sampling whose draw index is the tokens-generated-so-far
        count, so page eviction, replay, and re-prefill never shift
        the stream (the same (seed, index) always yields the same
        draw, and a replayed step consumes NO draw)."""
        s = req.sampling
        if not s:
            return int(probs_vec.argmax())
        return sample_token(probs_vec,
                            temperature=float(s.get("temperature", 0.0)),
                            seed=int(s.get("seed", 0)),
                            draw_index=len(req.tokens))

    # ------------------------------------------------------ page allocator
    def _map_page(self, row: int, slot: int, pid: int) -> None:
        """Map one physical page into a row's chain: host ownership
        map, device-table mirror, and refcount move together — the
        invariant ``_validate_page_table`` re-checks every step."""
        self.row_pages[row][slot] = pid
        self.table[row, slot] = pid
        self.page_ref[pid] += 1

    def _unref_page(self, pid: int) -> None:
        """Drop one reference; at zero the page returns to the free
        list and leaves the prefix index (a later identical prefix
        re-prefills — never maps a freed page)."""
        self.page_ref[pid] -= 1
        if self.page_ref[pid] == 0:
            self.free_pages.append(pid)
            key = self.page_key.pop(pid, None)
            if key is not None:
                self.prefix_pages.pop(key, None)

    def _registry_evict_one(self) -> None:
        """Drop the LRU full-prompt registry entry: its retained refs
        release (pages still mapped by live rows survive — only the
        registry's own holds go)."""
        _, entry = self.prompt_registry.popitem(last=False)
        for pid in entry["pages"]:
            self._unref_page(pid)

    def _alloc_page(self, exclude_row: Optional[int] = None
                    ) -> Optional[int]:
        """One physical page, walking the pressure ladder: free list ->
        drop LRU prefix-registry retentions -> steal the COLDEST
        droppable page from the oldest-admitted BULK row (never from
        ``exclude_row`` — stealing from the requester frees nothing
        net). ``None`` = genuinely out of pages; the caller stalls or
        falls back to whole-row eviction."""
        if self.free_pages:
            return self.free_pages.pop()
        while self.prompt_registry:
            self._registry_evict_one()
            if self.free_pages:
                return self.free_pages.pop()
        victims = sorted((s.admit_seq, i)
                         for i, s in enumerate(self.slots)
                         if s is not None and s.priority > 0
                         and i != exclude_row)
        for _, i in victims:
            j = self._coldest_droppable(i)
            if j is None:
                continue
            self._drop_page(i, j, reason="pressure")
            if self.free_pages:
                return self.free_pages.pop()
        return None

    def _coldest_droppable(self, row: int) -> Optional[int]:
        """Lowest page slot of ``row`` that is ENTIRELY decode-written
        (``slot*page_len >= prefill_len`` — replay can only re-derive
        decode content; prefill content needs the whole-row path) and
        fully behind the write position (never the page being
        written). Such pages are exclusive by construction."""
        pf, pos, pl = (self.prefill_lens[row], self.positions[row],
                       self.page_len)
        for j in sorted(self.row_pages[row]):
            if j * pl >= pf and (j + 1) * pl <= pos:
                return j
        return None

    def _drop_page(self, row: int, slot: int, reason: str) -> None:
        """Page-granular eviction: unmap + unref ONE page and roll the
        victim's position back to that page's first token. Subsequent
        normal decode steps REPLAY its recorded tokens from there —
        the identical computation re-derives the lost K/V bitwise,
        with emission suppressed until the row catches back up, so
        only what was lost re-computes."""
        req = self.slots[row]
        pid = self.row_pages[row].pop(slot)
        self.table[row, slot] = -1
        self._unref_page(pid)
        self.positions[row] = slot * self.page_len
        hist = req.history()
        self.tokens[row] = int(hist[self.positions[row]])
        get_registry().counter(
            "serving_kv_page_evictions_total",
            help="KV pages dropped under pool pressure or chaos (the "
                 "victim replays only the lost page)").inc()
        get_tracer().instant("kv_page_evicted", model=self.key, row=row,
                             slot=slot, reason=reason)
        flight_record("serving", "kv_page_evicted", model=self.key,
                      row=row, slot=slot, page=pid, reason=reason)

    def _release_row(self, row: int) -> None:
        """Free a row's slot and every page reference it holds — via
        the authoritative host ownership map, NEVER via the device
        table (a corrupted table must not steer releases)."""
        self.slots[row] = None
        for pid in self.row_pages[row].values():
            self._unref_page(pid)
        self.row_pages[row] = {}
        if self.rows:
            self.table[row, :] = -1
        self.tokens[row] = 0
        self.positions[row] = 0
        self.prefill_lens[row] = 0

    def _write_page(self, pid: int, cache1, start: int,
                    count: int) -> None:
        """Copy prefill K/V positions ``[start, start+count)`` into
        pool page ``pid`` across every attention node (one page group),
        in place, on the stream the next prefill will run on. Stale
        content past ``count`` is harmless: attention masks it to an
        EXACT-zero softmax contribution (it is finite), and the write
        position's slot is rewritten in-step before being read."""
        for n, kv in cache1.items():
            for k, v in kv.items():
                self.pool[n][k][pid, :, :count, :] = \
                    v[0, :, start:start + count, :]

    # ----------------------------------------------------- slot lifecycle
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def _publish_cache_gauge(self) -> None:
        with self.scheduler._cond:   # _engines mutates under the cond
            self.scheduler._publish_kv_gauge_locked()

    def _grow_allowed(self, new_rows: int) -> bool:
        # row slots are free under paging — MEMORY admission control
        # moved to the page allocator (a request that cannot get pages
        # re-queues; the pool bytes are fixed at engine build)
        return new_rows <= self.scheduler.max_rows

    def _resize(self, new_rows: int) -> None:
        """Re-bucket the decode batch. Under paging this is PURE HOST
        bookkeeping: the pool never moves, rows keep their page
        mappings, and only the per-row table/slot arrays re-index — no
        device gather, no cache copy, so parity is trivially
        unaffected and resize costs nothing on the accelerator."""
        live = [i for i, s in enumerate(self.slots) if s is not None]
        assert len(live) <= new_rows
        new_table = np.full((new_rows, self.pages_per_row), -1, np.int32)
        new_row_pages: List[Dict[int, int]] = [
            {} for _ in range(new_rows)]
        new_slots: List[Optional[_GenRequest]] = [None] * new_rows
        new_tokens, new_positions = [0] * new_rows, [0] * new_rows
        new_prefill = [0] * new_rows
        for j, i in enumerate(live):
            new_slots[j] = self.slots[i]
            new_tokens[j] = self.tokens[i]
            new_positions[j] = self.positions[i]
            new_prefill[j] = self.prefill_lens[i]
            new_table[j] = self.table[i]
            new_row_pages[j] = self.row_pages[i]
        self.slots, self.tokens, self.positions = (new_slots, new_tokens,
                                                   new_positions)
        self.prefill_lens = new_prefill
        self.table, self.row_pages = new_table, new_row_pages
        self.rows = new_rows
        self._publish_cache_gauge()

    def try_admit(self, req: _GenRequest) -> bool:
        """JOIN: admit one request — a full-prompt prefix-registry hit
        maps the retained pages and skips prefill ENTIRELY (TTFT
        collapses to page-mapping cost); the cold path prefills, then
        maps the prompt's pages with content-addressed FULL-page dedup
        against the pool. Returns False when no row slot or no pages
        are available (caller re-queues)."""
        row = next((i for i, s in enumerate(self.slots) if s is None),
                   None)
        if row is None:
            new_rows = next_pow_of_2(self.active() + 1)
            if not self._grow_allowed(new_rows):
                if not self._preempt_for(req):
                    return False
                row = next(i for i, s in enumerate(self.slots)
                           if s is None)
            else:
                self._resize(new_rows)
                row = next(i for i, s in enumerate(self.slots)
                           if s is None)
        if req.tokens and req.model_obj is not self.model:
            # an evicted victim re-admitted after the model was
            # reloaded as a NEW object: re-prefilling its old-model
            # tokens under the new weights would blend two models in
            # one response — fail it honestly instead
            req.fail(RuntimeError(
                "model reloaded while this generation awaited "
                "re-prefill after a cache eviction; retry"))
            return True
        req.model_obj = self.model
        history = req.history()
        L = len(history)
        pl = self.page_len
        # feasibility: the request's WORST-CASE page chain must fit the
        # pool outright, else it could never finish however long it
        # waits — fail loudly now instead of queueing forever
        remaining = max(req.max_new - len(req.tokens), 0)
        highest = (L - 1 if remaining <= 1
                   else min(L + remaining - 2, self.max_len - 1))
        need = highest // pl + 1
        if need > self.usable_pages:
            req.fail(ValueError(
                f"generation needs {need} KV pages ({L} prompt tokens "
                f"+ {remaining} new at page_len {pl}) but the pool "
                f"budget cannot hold more than {self.usable_pages}"))
            return True
        bucket = self.prefill_bucket(L)
        hist_t = tuple(int(t) for t in history)
        reg_key = (bucket, hist_t)
        with self.scheduler._stats_lock:
            self.scheduler.prefix_lookups += 1
        reg = get_registry()
        reg.counter("serving_prefix_cache_lookups_total",
                    help="full-prompt prefix-registry lookups at "
                         "admission").inc()
        entry = self.prompt_registry.get(reg_key)
        n_full, tail_len = L // pl, L % pl
        if entry is not None:
            # FULL-PROMPT HIT: an identical prompt prefilled earlier —
            # map its retained pages (refcount++, read-only by
            # construction), restore the partial tail page from host
            # copies into a fresh EXCLUSIVE write page, and re-select
            # the first token from the cached prefill probs per THIS
            # request's sampling config. No prefill step runs.
            self.prompt_registry.move_to_end(reg_key)
            wp = None
            if tail_len:
                wp = self._alloc_page(exclude_row=row)
                if wp is None:
                    return False
            for j, pid in enumerate(entry["pages"]):
                self._map_page(row, j, pid)
            if wp is not None:
                for n, kv in entry["tail"].items():
                    for k, v in kv.items():
                        self.pool[n][k][wp, :, :tail_len, :] = v
                self._map_page(row, n_full, wp)
            first = self._select(req, entry["probs"])
            with self.scheduler._stats_lock:
                self.scheduler.prefix_hits += 1
            reg.counter("serving_prefix_cache_hits_total",
                        help="admissions that skipped prefill via the "
                             "full-prompt prefix registry").inc()
            get_tracer().instant("prefix_cache_hit", model=self.key,
                                 tokens=L)
            flight_record("serving", "prefix_cache_hit", model=self.key,
                          tokens=L, row=row)
        else:
            try:
                probs_vec, cache1 = self._prefill(req)
            except Exception as e:  # noqa: BLE001 — fail THIS alone
                req.fail(e)
                return True
            # map + fill the prompt's page chain, deduping FULL pages
            # content-addressed: same prefill bucket + same exact token
            # prefix => bitwise-identical K/V (row-independent matmuls;
            # suffix tokens contribute EXACTLY zero through the causal
            # mask), so the page is shared and the pool write skipped
            new_refs = []
            ok = True
            for j in range(n_full):
                pkey = (bucket, hist_t[:(j + 1) * pl])
                pid = self.prefix_pages.get(pkey)
                if pid is not None:
                    self._map_page(row, j, pid)     # dedup: no write
                    new_refs.append((j, pid))
                    continue
                pid = self._alloc_page(exclude_row=row)
                if pid is None:
                    ok = False
                    break
                self._write_page(pid, cache1, j * pl, pl)
                self._map_page(row, j, pid)
                self.prefix_pages[pkey] = pid
                self.page_key[pid] = pkey
                new_refs.append((j, pid))
            if ok and tail_len:
                wp = self._alloc_page(exclude_row=row)
                if wp is None:
                    ok = False
                else:
                    self._write_page(wp, cache1, n_full * pl, tail_len)
                    self._map_page(row, n_full, wp)
                    new_refs.append((n_full, wp))
            if not ok:
                # pages ran out mid-mapping: undo the refs taken and
                # re-queue (the wasted prefill is the price of not
                # holding pages hostage across the queue)
                for j, pid in new_refs:
                    del self.row_pages[row][j]
                    self.table[row, j] = -1
                    self._unref_page(pid)
                return False
            first = self._select(req, probs_vec)
            self._registry_insert(reg_key, row, n_full, cache1, L,
                                  tail_len, probs_vec)
        if req.ttft_s is None:  # a re-prefilled victim keeps its first
            req.ttft_s = time.monotonic() - req.t0
            self.scheduler.ttft.observe(req.ttft_s)
        req.push_token(first)
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[row] = req
        self.tokens[row] = first
        # next decode writes `first`'s K/V at position = history length
        self.positions[row] = L
        self.prefill_lens[row] = L
        if len(req.tokens) >= req.max_new \
                or self.positions[row] >= self.max_len:
            self._complete(row)      # prompt-only TTFT request
        return True

    def _registry_insert(self, reg_key, row: int, n_full: int, cache1,
                         L: int, tail_len: int, probs_vec) -> None:
        """Retain this prompt's prefill for later identical prompts:
        refcount++ on its FULL pages (they outlive the row), host
        copies of the partial tail page (a hit restores them into a
        fresh exclusive write page — shared pages stay read-only), and
        the prefill probs row (a hit re-selects its first token per
        request). LRU-capped; eviction only drops the registry's own
        refs, so pages still mapped by live rows survive it."""
        if reg_key in self.prompt_registry:
            self.prompt_registry.move_to_end(reg_key)
            return
        pages = [self.row_pages[row][j] for j in range(n_full)]
        for pid in pages:
            self.page_ref[pid] += 1
        pl = self.page_len
        tail = {}
        if tail_len:
            tail = {n: {k: v[0, :, n_full * pl:L, :].to("cpu", copy=True)
                        for k, v in kv.items()}
                    for n, kv in cache1.items()}
        self.prompt_registry[reg_key] = {
            "pages": pages, "tail": tail, "tail_len": tail_len,
            "probs": np.array(probs_vec, np.float32),
            "prefill_len": L}
        while len(self.prompt_registry) > \
                self.scheduler.prefix_registry_cap:
            self._registry_evict_one()

    def _preempt_for(self, req: _GenRequest) -> bool:
        """Ring-buffer eviction under pressure: an INTERACTIVE arrival
        evicts the oldest-admitted BULK row rather than waiting behind
        it. Bulk arrivals never preempt."""
        if req.priority != 0:
            return False
        victims = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                   if s is not None and s.priority > 0]
        if not victims:
            return False
        self.evict_row(min(victims)[1], reason="preempt")
        return True

    def evict_row(self, row: int, reason: str = "pressure") -> None:
        """LEAVE (involuntary): push the victim back onto the queue;
        its history re-prefills when capacity returns — its pages free
        immediately through the host ownership map, never salvaged."""
        victim = self.slots[row]
        if victim is None:
            return
        victim.reprefills += 1
        self._release_row(row)
        reg = get_registry()
        reg.counter("serving_kv_evictions_total",
                    help="KV-cache rows evicted (ring-buffer pressure "
                         "or chaos)").inc()
        reg.counter("serving_reprefills_total",
                    help="evicted generations re-queued for "
                         "re-prefill").inc()
        get_tracer().instant("kv_evicted", model=self.key, row=row,
                             reason=reason)
        flight_record("serving", "kv_evicted", model=self.key, row=row,
                      reason=reason)
        self.scheduler._requeue(self.key, victim)

    def ring_victim(self) -> Optional[int]:
        """Oldest-admitted live row — the ring-buffer eviction order."""
        live = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                if s is not None]
        return min(live)[1] if live else None

    def _complete(self, row: int) -> None:
        req = self.slots[row]
        self._release_row(row)
        get_registry().counter(
            "serving_generated_tokens_total",
            help="tokens generated by the decode engine").inc(
                len(req.tokens))
        with self.scheduler._stats_lock:
            self.scheduler.tokens_out += len(req.tokens)
        req.finish()

    # ------------------------------------------------------------- decode
    def _nth_oldest(self, live, rank: int) -> Optional[int]:
        """The ``rank``-th oldest-admitted live row (chaos targeting);
        clamps to the oldest available."""
        if not live:
            return None
        ordered = sorted((self.slots[i].admit_seq, i) for i in live)
        return ordered[min(max(rank, 0), len(ordered) - 1)][1]

    def _validate_page_table(self, live):
        """Host-side page-table validation, every iteration BEFORE the
        table reaches a step: each live row's device table
        must mirror the authoritative ``row_pages`` ownership map
        (in-pool, un-freed pages only), and the row's WRITE page must
        be exclusive (refcount 1) — the 'shared prefix pages are
        read-only by construction' assert. A corrupt row fails ALONE
        with a structured PAGE_TABLE error; its pages release via the
        ownership map, never via the corrupted table — so cross-row
        cache garbage is structurally impossible."""
        ok = []
        for i in live:
            req = self.slots[i]
            mapped = self.row_pages[i]
            bad = None
            for j in range(self.pages_per_row):
                want = mapped.get(j, -1)
                got = int(self.table[i, j])
                if got != want:
                    bad = (f"slot {j} maps page {got}, host ownership "
                           f"says {want}")
                    break
                if want >= 0 and not 0 < want < self.total_pages:
                    bad = f"slot {j} maps out-of-pool page {want}"
                    break
                if want >= 0 and self.page_ref[want] < 1:
                    bad = f"slot {j} maps freed page {want}"
                    break
            if bad is None:
                wslot = self.positions[i] // self.page_len
                wpid = mapped.get(wslot)
                if wpid is not None and self.page_ref[wpid] != 1:
                    bad = (f"write page {wpid} (slot {wslot}) is "
                           f"SHARED (refcount {self.page_ref[wpid]}) — "
                           f"shared prefix pages are read-only by "
                           f"construction")
            if bad is None:
                ok.append(i)
                continue
            get_registry().counter(
                "serving_page_table_corruptions_total",
                help="decode rows failed by host-side page-table "
                     "validation before any decode step ran").inc()
            get_tracer().instant("page_table_corrupt", model=self.key,
                                 row=i)
            flight_record("serving", "page_table_corrupt",
                          model=self.key, row=i, detail=bad)
            req.fail(PageTableCorruption(
                f"decode row {i}: {bad}; failing this row alone (its "
                f"pages release via the host ownership map — the "
                f"corrupt table never reached a decode step)"))
            self._release_row(i)
        return ok

    def decode_iteration(self) -> None:
        """One engine step: decode ONE token for every live row."""
        self.iteration += 1
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return
        # deadline-blown rows leave before paying for the step
        for i in list(live):
            req = self.slots[i]
            if req.deadline.expired():
                req.fail(DeadlineExceeded(
                    "generate: budget exhausted mid-stream at "
                    f"token {len(req.tokens)}"))
                self._release_row(i)
                live.remove(i)
        if not live:
            return
        # corrupt_page_table chaos scribbles BEFORE validation — the
        # validator must provably catch it
        rank = faultinject.check_corrupt_page_table()
        if rank is not None:
            t = self._nth_oldest(live, rank)
            if t is not None:
                self.table[t, self.positions[t] // self.page_len] = \
                    self.total_pages + 7
        live = self._validate_page_table(live)
        if not live:
            return
        # evict_page chaos: drop the target's coldest droppable page —
        # the exact path pool pressure takes (no droppable page =>
        # whole-row fallback, same as the real pressure ladder)
        rank = faultinject.check_evict_page()
        if rank is not None:
            t = self._nth_oldest(live, rank)
            if t is not None:
                j = self._coldest_droppable(t)
                if j is not None:
                    self._drop_page(t, j, reason="chaos")
                else:
                    self.evict_row(t, reason="chaos")
                    live.remove(t)
        if not live:
            return
        # every live row needs its WRITE page mapped before dispatch;
        # a row that cannot get one STALLS this step (its scatter
        # would otherwise land on scratch and lose the token)
        stalled = []
        for i in list(live):
            wslot = self.positions[i] // self.page_len
            if wslot not in self.row_pages[i]:
                pid = self._alloc_page(exclude_row=i)
                if pid is None:
                    stalled.append(i)
                    live.remove(i)
                else:
                    self._map_page(i, wslot, pid)
        if not live:
            if stalled:
                # EVERY live row is stalled on allocation: page-level
                # pressure has nothing left to give, so fall back to
                # whole-ROW eviction of the oldest — the pool drains
                # and the rest make progress (eventual serialization,
                # never deadlock)
                victim = self.ring_victim()
                if victim is not None:
                    self.evict_row(victim, reason="page-pressure")
            return
        x = np.zeros((self.rows, 1, self.vocab), np.float32)
        for i in live:
            x[i, 0] = self._eye[self.tokens[i]]
        positions = np.asarray(self.positions, np.int64)
        # derived DEVICE table: unmapped slots alias scratch page 0,
        # so free/stalled rows' scatters never touch a live page
        table = np.where(self.table < 0, 0, self.table).astype(np.int64)
        runner = self._compiled("decode", self.rows)
        tracer = get_tracer()
        watchdog_beat("serving_decode")
        flight_record("serving", "decode_dispatch", model=self.key,
                      rows=self.rows, live=len(live),
                      iteration=self.iteration)
        with tracer.span("serve:decode", model=self.key, rows=self.rows,
                         live=len(live), iteration=self.iteration):
            try:
                with self.lock:
                    probs, _ = runner(
                        self.model.params, self.model.states,
                        self.pool, x, positions, table)
            except Exception:  # noqa: BLE001 — isolate batchmates
                # batch-level decode failure: re-run each live row ALONE
                # before surfacing anything (the singleton-fallback
                # discipline, per decode step). Whatever the failed step
                # scattered lies at the rows' write positions, which
                # each re-run writes again before reading
                get_registry().counter(
                    "serving_decode_fallbacks_total",
                    help="decode steps re-run as singletons after a "
                         "batch-level failure").inc()
                probs = self._singleton_fallback(live, x, positions,
                                                 table)
        reg = get_registry()
        reg.counter("serving_decode_steps_total",
                    help="batched decode steps executed").inc()
        reg.histogram("serving_decode_batch_rows",
                      help="live generations per decode step",
                      buckets=DECODE_ROWS_BUCKETS).observe(len(live))
        with self.scheduler._stats_lock:   # traffic mix (prewarm signal)
            self.scheduler._mix[("decode", self.rows)] += 1
        for i in live:
            req = self.slots[i]
            if req is None:
                continue
            row_probs = probs[i]
            # a row is REPLAYING (rebuilding a dropped page) while its
            # position has not caught back up to its recorded history:
            # the step's K/V write is the point, the probs re-derive
            # tokens the request already holds
            hist_len = len(req.prompt) + len(req.tokens)
            replaying = self.positions[i] + 1 < hist_len
            if not replaying:
                if faultinject.poison_decode_row(req.index,
                                                 req.steps + 1):
                    row_probs = np.full_like(row_probs, np.nan)
                if host_nonfinite(row_probs):
                    reg.counter(
                        "serving_nonfinite_outputs_total",
                        help="predictions refused because the model "
                             "output carried NaN/Inf").inc()
                    req.fail(NonFiniteOutput(
                        f"generation row turned NaN/Inf at token "
                        f"{len(req.tokens) + 1}"))
                    self._release_row(i)  # fails ALONE, mid-stream
                    continue
            req.steps += 1
            self.positions[i] += 1
            if replaying:
                # emission suppressed: feed the NEXT recorded token —
                # identical computation re-derives the lost K/V bitwise
                hist = req.history()
                self.tokens[i] = int(hist[self.positions[i]])
                continue
            tok = self._select(req, row_probs)
            req.push_token(tok)
            self.tokens[i] = tok
            if len(req.tokens) >= req.max_new \
                    or self.positions[i] >= self.max_len:
                self._complete(i)
        # evict_cache chaos: force one ring eviction, exactly what HBM
        # pressure would do — the victim must re-prefill, never garbage
        if faultinject.check_evict_cache():
            victim = self.ring_victim()
            if victim is not None:
                self.evict_row(victim, reason="chaos")
        # compact: a half-empty bucket shrinks to its pow2
        target = max(1, next_pow_of_2(max(1, self.active())))
        if target < self.rows:
            self._resize(target)

    def _singleton_fallback(self, live, x, positions, table):
        """Re-run each live row in the 1-row decode bucket; rows that
        fail alone surface their own error (and only those may charge
        the caller's breaker). Every 1-row call updates the same pool
        in place, so successful rows' page writes land exactly where
        the batched step would have put them — no write-back pass."""
        probs = np.zeros((self.rows, self.vocab), np.float32)
        for i in list(live):
            req = self.slots[i]
            try:
                runner = self._compiled("decode", 1)
                with self.lock:
                    p1, _ = runner(
                        self.model.params, self.model.states,
                        self.pool, x[i:i + 1], positions[i:i + 1],
                        table[i:i + 1])
                probs[i] = p1[0]
            except Exception as e:  # noqa: BLE001 — per-row verdict
                req.fail(e)
                self._release_row(i)
        return probs

    def fail_all(self, error: BaseException) -> None:
        for i, req in enumerate(self.slots):
            if req is not None:
                req.fail(error)
                self._release_row(i)


class GenerationScheduler:
    """Per-server token-level scheduler. ``submit()`` is called by an
    admitted handler thread (holding its ServiceGuard slot) and blocks
    until the generation completes; a per-model decode-loop thread owns
    the engine. The caller resolves the model key ONCE at admission —
    eviction or an LRU swap can never retarget a queued request."""

    def __init__(self, max_rows: int = 8, max_wait_ms: float = 0.0,
                 cache_budget_bytes: Optional[int] = None,
                 idle_thread_s: float = 30.0,
                 compile_cache: Optional[CompileCache] = None,
                 prewarm_top: int = 3,
                 prewarm_decode_ladder: bool = False,
                 kv_page_len: Optional[int] = None,
                 prefix_registry_cap: int = 32):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.max_rows = next_pow_of_2(int(max_rows))
        if self.max_rows > max_rows:
            self.max_rows >>= 1
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.cache_budget_bytes = cache_budget_bytes
        # None = per-model default (analysis.memory.default_kv_page_len)
        self.kv_page_len = kv_page_len
        self.prefix_registry_cap = max(0, int(prefix_registry_cap))
        self.idle_thread_s = idle_thread_s
        self.prewarm_top = prewarm_top
        # compile the whole pow2 decode-rows ladder at engine build:
        # log2(max_rows)+1 small programs buy DETERMINISTIC zero-
        # recompile steady state whatever row counts churn produces
        self.prewarm_decode_ladder = prewarm_decode_ladder
        self._cond = threading.Condition()
        self._queues: Dict[str, collections.deque] = {}
        self._backends: Dict[str, tuple] = {}
        self._engines: Dict[str, _Engine] = {}
        self._loops: Dict[str, threading.Thread] = {}
        self._compiled = (compile_cache if compile_cache is not None
                          else get_compile_cache())
        self._cache_owner = next_cache_owner()
        self._stopping = False
        self._stats_lock = threading.Lock()
        self.compile_s = 0.0
        self.compiles = 0
        self.tokens_out = 0
        self.prefill_steps = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        # _mix = OBSERVED traffic per (kind, bucket) — the speculative-
        # prewarm ranking signal; _compiles_per_bucket = compiles per
        # bucket — the zero-recompile gate surface (a value > 1 means a
        # shape was re-traced, whatever the traffic was)
        self._mix: collections.Counter = collections.Counter()
        self._compiles_per_bucket: collections.Counter = \
            collections.Counter()
        self._submits = 0
        self.ttft = _LatencyWindow(
            hist_name="serving_ttft_seconds",
            hist_help="time to first token (admission to the "
                      "prefill's first greedy token)",
            gauge_prefix="serving_ttft", gauge_what="time to first "
                                                    "token")

    # -------------------------------------------------------------- submit
    def submit(self, key: str, model, lock: threading.Lock,
               prompt, max_new_tokens: int, deadline: Deadline,
               priority: str = "interactive", on_token=None,
               sampling: Optional[dict] = None) -> dict:
        """Queue one generation and block until it completes. Returns
        ``{"tokens": [...], "ttft_ms": ..., "reprefills": n}``; raises
        the request's own structured error. ``on_token`` (optional) is
        invoked on the decode-loop thread with each token the moment it
        is generated — the streaming-gateway seam; exceptions it raises
        only stop the streaming, never the generation. ``sampling``
        (optional) is ``{"temperature": t, "seed": s}`` — seeded
        temperature sampling instead of the default greedy argmax;
        ``temperature`` 0 stays greedy, and a fixed seed pins a
        bitwise-reproducible token stream."""
        prompt = np.asarray(prompt, np.int32).ravel()
        vocab = model.decode_vocab()
        max_len = model.decode_max_len()
        if prompt.size < 1:
            raise ValueError("generate needs a non-empty prompt")
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError(f"prompt token out of range [0, {vocab})")
        if prompt.size >= max_len:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to "
                f"generate (max sequence length {max_len})")
        max_new = min(int(max_new_tokens), max_len - prompt.size)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sampling is not None:
            if not isinstance(sampling, dict):
                raise ValueError(
                    'sampling must be an object like '
                    '{"temperature": t, "seed": s}')
            try:
                t = float(sampling.get("temperature", 0.0))
                s = int(sampling.get("seed", 0))
            except (TypeError, ValueError):
                raise ValueError(
                    "sampling.temperature must be a number and "
                    "sampling.seed an integer") from None
            if t < 0:
                raise ValueError("sampling.temperature must be >= 0")
            sampling = {"temperature": t, "seed": s}
        deadline.check("generate enqueue")
        with self._cond:
            if self._stopping:
                raise DrainingError("generation scheduler stopped")
            self._submits += 1
            req = _GenRequest(prompt, max_new, priority_rank(priority),
                              deadline, faultinject.on_generate_submit(),
                              on_token=on_token, sampling=sampling)
            self._backends[key] = (model, lock)
            self._enqueue_locked(key, req)
            loop = self._loops.get(key)
            if loop is None or not loop.is_alive():
                loop = threading.Thread(
                    target=self._decode_loop, args=(key,), daemon=True,
                    name=f"gen-decode-{len(self._loops)}")
                self._loops[key] = loop
                loop.start()
            self._cond.notify_all()
        while not req.event.is_set():
            remaining = deadline.remaining()
            timeout = 5.0 if remaining is None else max(0.0,
                                                        remaining) + 0.05
            if req.event.wait(timeout):
                break
            deadline.check("generate in flight")
        if req.error is not None:
            raise req.error
        if not req.event.is_set() or (req.error is None
                                      and not req.tokens):
            raise DrainingError("generation scheduler stopped")
        return {"tokens": list(req.tokens),
                "ttft_ms": (None if req.ttft_s is None
                            else round(req.ttft_s * 1000.0, 3)),
                "reprefills": req.reprefills}

    def _count_capture(self, key: str, kind: str, bucket: int,
                       elapsed: float) -> None:
        """Count one (re-)capture of a (kind, bucket) step — the
        zero-capture gate's surface (a bucket counted twice was captured
        again, whatever the traffic was)."""
        get_registry().counter(
            "serving_compile_seconds_total",
            help="seconds spent capturing per-bucket steps (CUDA graphs; "
                 "eager CPU steps capture nothing)").inc(elapsed)
        with self._stats_lock:
            self.compile_s += elapsed
            self.compiles += 1
            self._compiles_per_bucket[(key, kind, bucket)] += 1

    def _enqueue_locked(self, key: str, req: _GenRequest) -> None:
        priority_insert(
            self._queues.setdefault(key, collections.deque()), req)

    def _requeue(self, key: str, req: _GenRequest) -> None:
        """An evicted victim goes back FIRST within its priority class:
        it already waited its turn once."""
        with self._cond:
            priority_insert(
                self._queues.setdefault(key, collections.deque()), req,
                front_of_class=True)
            self._cond.notify_all()

    def _abandon_loop(self, key: str, error: BaseException) -> None:
        """Abnormal decode-loop exit: fail the queue AND deregister the
        loop in ONE cond hold — a submit that lands after this hold
        sees no (still-alive) loop entry and spawns a fresh one, so a
        request can never be stranded behind a thread that is merely
        unwinding."""
        with self._cond:
            for r in (self._queues.get(key) or ()):
                r.fail(error)
            self._queues.pop(key, None)
            if self._loops.get(key) is threading.current_thread():
                del self._loops[key]
            if self._engines.pop(key, None) is not None:
                self._publish_kv_gauge_locked()

    def _publish_kv_gauge_locked(self) -> None:
        """Publish resident KV bytes across live engines — callers hold
        ``self._cond`` (every resize, retire, and swap republishes, so
        freed pools never linger on the gauge). Under paging the pool
        is FIXED at engine build: the gauge is the page-granular
        eviction budget surface, and prefix sharing dedups occupancy
        BELOW it (see ``kv_pages_*`` in ``stats()``)."""
        get_registry().gauge(
            "serving_kv_cache_bytes",
            help="resident KV page-pool bytes across decode engines"
        ).set(sum(e.pool_bytes for e in self._engines.values()))

    # --------------------------------------------------------- decode loop
    def _decode_loop(self, key: str) -> None:
        engine: Optional[_Engine] = None
        idle_until = time.monotonic() + self.idle_thread_s
        while True:
            admitted: List[_GenRequest] = []
            with self._cond:
                queue = self._queues.get(key)
                active = engine.active() if engine is not None else 0
                while not self._stopping and not queue and active == 0:
                    left = idle_until - time.monotonic()
                    if left <= 0:
                        # retire the idle loop AND its engine: the
                        # bucket's KV caches free with it (a later
                        # submit rebuilds both)
                        if self._loops.get(key) \
                                is threading.current_thread():
                            del self._loops[key]
                            if self._engines.pop(key, None) is not None:
                                self._publish_kv_gauge_locked()
                            if not self._queues.get(key):
                                self._queues.pop(key, None)
                        return
                    self._cond.wait(left)
                    queue = self._queues.get(key)
                if self._stopping:
                    for r in (queue or ()):
                        r.fail(DrainingError(
                            "generation scheduler stopped"))
                    if queue is not None:
                        queue.clear()
                    if engine is not None:
                        engine.fail_all(DrainingError(
                            "generation scheduler stopped"))
                    if self._engines.pop(key, None) is not None:
                        self._publish_kv_gauge_locked()
                    return
                backend = self._backends.get(key)
            if backend is None:
                # the LRU evicted the model with nothing pinning it:
                # queued AND in-flight requests fail cleanly, and the
                # engine (with its KV caches) must go with it — leaving
                # it in _engines would leak the caches and pin the dead
                # model object
                if engine is not None:
                    engine.fail_all(DrainingError(
                        f"model {key!r} evicted mid-generation"))
                self._abandon_loop(key, DrainingError(
                    f"model {key!r} evicted with requests queued"))
                return
            admit_ok = True
            if engine is not None and engine.model is not backend[0]:
                # the server LRU evicted this model and a later request
                # reloaded it as a NEW object: rows already decoding
                # keep THEIR model (their KV caches were built from its
                # weights — switching mid-stream would serve garbage),
                # but nothing new may join; the engine rebuilds against
                # the fresh object once its in-flight rows drain
                if engine.active() == 0:
                    with self._cond:
                        self._engines.pop(key, None)
                        self._publish_kv_gauge_locked()
                    engine = None
                else:
                    admit_ok = False
            if engine is None:
                try:
                    engine = _Engine(self, key, backend[0], backend[1])
                except Exception as e:  # noqa: BLE001 — not a decoder
                    self._abandon_loop(key, e)
                    return
                with self._stats_lock:
                    mix = self._mix.most_common()
                if self.prewarm_decode_ladder:
                    rows, ladder = 1, []
                    while rows <= self.max_rows:
                        ladder.append((("decode", rows), 0))
                        rows <<= 1
                    engine.prewarm(ladder, len(ladder))
                if mix:
                    engine.prewarm(mix, self.prewarm_top)
                with self._cond:
                    self._engines[key] = engine
            # JOIN: admit as many queued requests as capacity allows,
            # priority first — this happens EVERY iteration, so
            # requests join mid-flight of their batchmates
            while admit_ok:
                with self._cond:
                    queue = self._queues.get(key)
                    req = queue[0] if queue else None
                    if req is not None:
                        queue.popleft()
                if req is None:
                    break
                if req.deadline.expired():
                    req.fail(DeadlineExceeded(
                        "generate: budget exhausted in queue"))
                    continue
                if not engine.try_admit(req):
                    # no capacity: put it back at the FRONT OF ITS
                    # CLASS (not the absolute front — a blocked bulk
                    # head must not shadow an interactive arrival that
                    # could preempt its way in)
                    self._requeue(key, req)
                    break
                admitted.append(req)
            if engine.active() == 0:
                # nothing decodable (queue blocked on capacity is
                # impossible with 0 active; queue empty otherwise)
                idle_until = time.monotonic() + self.idle_thread_s
                continue
            # small join window at low occupancy: let concurrent
            # arrivals coalesce into the same decode step
            if self.max_wait_s > 0 and engine.active() < self.max_rows \
                    and not admitted:
                with self._cond:
                    if not self._queues.get(key):
                        self._cond.wait(self.max_wait_s)
            try:
                engine.decode_iteration()
            except Exception as e:  # noqa: BLE001 — the loop survives
                engine.fail_all(e)
            idle_until = time.monotonic() + self.idle_thread_s

    # ------------------------------------------------------------ lifecycle
    def evict_model(self, key: str) -> None:
        """Drop the compiled buckets and the backend registration for
        an evicted model (the compile cache dies with the server LRU).
        Any still-queued or in-flight generation for the key fails
        cleanly with DRAINING at the next loop iteration — callers who
        want in-flight work to finish must not evict while ops are in
        flight (KerasServer's pinned-model LRU guarantees exactly
        that, so over the gateway this only ever fires idle)."""
        with self._cond:   # serialize purge+pop against compile puts
            self._compiled.evict_model(self._cache_owner, key)
            self._backends.pop(key, None)

    def stop(self, grace_s: float = 5.0) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            loops = list(self._loops.values())
        for w in loops:
            w.join(grace_s)
        # release this scheduler's slice of the global compile cache
        self._compiled.evict_owner(self._cache_owner)

    def stats(self) -> dict:
        p50, p99 = self.ttft.quantiles()
        with self._cond:
            engines = list(self._engines.values())
        # pool occupancy: used = allocated page groups, shared = pages
        # with refcount > 1 (prefix dedup across rows / the registry) —
        # the dedup savings the page pool buys below its fixed ceiling
        pages_total = sum(e.usable_pages for e in engines)
        pages_used = sum(e.total_pages - 1 - len(e.free_pages)
                        for e in engines)
        pages_shared = sum(
            sum(1 for pid in range(1, e.total_pages)
                if e.page_ref[pid] > 1) for e in engines)
        with self._stats_lock:
            return {
                "compile_s": round(self.compile_s, 3),
                "compiles": self.compiles,
                "tokens_out": self.tokens_out,
                "prefill_steps": self.prefill_steps,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefix_cache_hit_rate": round(
                    self.prefix_hits / max(1, self.prefix_lookups), 4),
                "kv_pages_total": pages_total,
                "kv_pages_used": pages_used,
                "kv_pages_shared": pages_shared,
                "bucket_mix": {f"{k}:{b}": n for (k, b), n in
                               sorted(self._mix.items())},
                "bucket_compiles": {f"{m}:{k}:{b}": n
                                    for (m, k, b), n in sorted(
                                        self._compiles_per_bucket
                                        .items())},
                "ttft_p50_ms": (None if p50 is None
                                else round(p50 * 1000, 2)),
                "ttft_p99_ms": (None if p99 is None
                                else round(p99 * 1000, 2)),
            }
