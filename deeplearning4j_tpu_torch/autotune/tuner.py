"""The search loop: enumerate -> prune -> rank -> probe -> TunedConfig
(the JAX package's ``autotune/tuner.py``).

``autotune(net, devices=..., hbm_budget=...)``: given a model, a rank
count and a per-device memory budget, the port picks its own
configuration:

1. **Enumerate** the structural space (``autotune/space``): every
   dp x tp x pp x sp factorization of the rank count, crossed with
   gradient-accumulation, precision preset, and weight-update-sharding
   choices.
2. **Prune** with the validators the port already trusts: any candidate
   whose ``analysis.graphcheck.validate_config`` run produces an ERROR
   finding is out (memoized per (mesh, wus, precision)), and any whose
   analytic per-device memory exceeds the budget.
3. **Rank** survivors by the analytic step-time model
   (``autotune/model``), ties toward the simplest shape.
4. **Probe** the top-K probeable candidates, plus the default config
   (``MeshContext.create()``'s all-ranks dp), with a few REAL steps on
   the current process group (``autotune/probe``). Each rank times its
   own probe; the seconds are reduced to their maximum over the group
   before the winner is chosen, so every rank returns the same
   ``TunedConfig``. The winner is the best MEASURED candidate, so the
   tuner never ships a config that measures slower than the default.
5. Emit a :class:`~deeplearning4j_tpu_torch.autotune.config.TunedConfig`
   carrying the choice and each probe's ``measured_vs_predicted_gap``,
   also exported as ``autotune_*`` metrics.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.autotune import model as cost_model
from deeplearning4j_tpu_torch.autotune import space as cfg_space
from deeplearning4j_tpu_torch.autotune.config import ProbeRecord, TunedConfig
from deeplearning4j_tpu_torch.autotune.probe import world_size
from deeplearning4j_tpu_torch.autotune.space import Candidate

logger = logging.getLogger(__name__)


class AutotuneError(ValueError):
    """No legal configuration survived pruning (or probing failed in a
    way that leaves nothing to choose)."""


def _resolve_devices(devices):
    """(None, count) from None (the process group's world, 1 without a
    group), an int, or a device list (its length). An int above the world
    plans for that many ranks: the analytic search and an injected
    ``probe_fn`` take it; a real probe raises naming the world."""
    if devices is None:
        return None, world_size()
    if isinstance(devices, int):
        if devices < 1:
            raise AutotuneError(f"devices must be >= 1, got {devices}")
        return None, devices
    return None, len(list(devices))


def _max_over_ranks(values):
    """``values`` (floats) reduced to their maximum over the default
    process group (themselves without one)."""
    import torch
    import torch.distributed as dist
    if world_size() == 1:
        return list(values)
    device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def legal_findings(conf, candidate: Candidate, global_batch: int,
                   _cache: Optional[dict] = None):
    """graphcheck's verdict on one candidate (the ERROR findings that
    make it illegal). Memoized on (mesh, wus, precision) — the only
    knobs the rules read; gradient accumulation cannot change legality,
    so a 100-config sweep runs the validator once per distinct layout,
    not once per candidate."""
    from deeplearning4j_tpu_torch.analysis.findings import Severity
    from deeplearning4j_tpu_torch.analysis.graphcheck import validate_config
    key = (tuple(sorted(candidate.mesh_axes.items())),
           candidate.weight_update_sharding, candidate.precision)
    if _cache is not None and key in _cache:
        return _cache[key]
    findings = [f for f in validate_config(
        conf, mesh=candidate.mesh_axes, batch_size=global_batch,
        weight_update_sharding=candidate.weight_update_sharding,
        precision=candidate.precision)
        if f.severity == Severity.ERROR]
    if _cache is not None:
        _cache[key] = findings
    return findings


def analytic_search(census, n_devices: int, global_batch: int,
                    hbm_budget: Optional[int] = None,
                    accum_choices: Sequence[int] = cfg_space.DEFAULT_ACCUM,
                    precisions: Sequence[str] = cfg_space.DEFAULT_PRECISIONS,
                    wus_modes: Sequence[str] = cfg_space.DEFAULT_WUS_MODES,
                    hardware: Optional[cost_model.Hardware] = None,
                    ) -> Tuple[List[Tuple[Candidate, dict]], Dict[str, int]]:
    """Enumerate + prune + rank. Returns (ranked survivors as
    (candidate, predicted-cost dict) best first, prune counters).
    Shared by :func:`autotune` and graphcheck's GC016 rule, so the
    validator's notion of "the best legal config" IS the tuner's."""
    from deeplearning4j_tpu_torch.analysis.memory import DEFAULT_HBM_BYTES
    budget = hbm_budget or DEFAULT_HBM_BYTES
    hw = hardware or cost_model.Hardware.detect()
    legality_cache: dict = {}
    counters = {"candidates": 0, "pruned_illegal": 0, "pruned_hbm": 0}
    survivors: List[Tuple[Candidate, dict]] = []
    for cand in cfg_space.enumerate_space(
            n_devices, global_batch, accum_choices=accum_choices,
            precisions=precisions, wus_modes=wus_modes):
        counters["candidates"] += 1
        if legal_findings(census.conf, cand, global_batch,
                          _cache=legality_cache):
            counters["pruned_illegal"] += 1
            continue
        predicted = cost_model.predict(census, cand, global_batch,
                                       hardware=hw)
        if predicted["hbm_bytes"] > budget:
            counters["pruned_hbm"] += 1
            continue
        survivors.append((cand, predicted))
    survivors.sort(key=lambda cp: (cp[1]["step_s"], cp[0].sort_key()))
    return survivors, counters


def analytic_best(census, n_devices: int, global_batch: int,
                  hbm_budget: Optional[int] = None,
                  hardware: Optional[cost_model.Hardware] = None
                  ) -> Optional[Tuple[Candidate, dict]]:
    """The best LEGAL candidate by prediction alone — graphcheck's
    GC016 path. Ranks the whole structural space analytically (cheap:
    dict math per candidate), then walks down the ranking running the
    validator only until the first legal config, so the mistuning rule
    costs a handful of validator passes instead of one per layout."""
    from deeplearning4j_tpu_torch.analysis.memory import DEFAULT_HBM_BYTES
    budget = hbm_budget or DEFAULT_HBM_BYTES
    hw = hardware or cost_model.Hardware.detect()
    ranked = sorted(
        ((cand, cost_model.predict(census, cand, global_batch,
                                   hardware=hw))
         for cand in cfg_space.enumerate_space(n_devices, global_batch)),
        key=lambda cp: (cp[1]["step_s"], cp[0].sort_key()))
    cache: dict = {}
    for cand, predicted in ranked:
        if predicted["hbm_bytes"] > budget:
            continue
        if not legal_findings(census.conf, cand, global_batch,
                              _cache=cache):
            return cand, predicted
    return None


def autotune(net, devices=None, hbm_budget: Optional[int] = None,
             batch=None, global_batch: Optional[int] = None,
             accum_choices: Sequence[int] = cfg_space.DEFAULT_ACCUM,
             precisions: Sequence[str] = cfg_space.DEFAULT_PRECISIONS,
             wus_modes: Sequence[str] = cfg_space.DEFAULT_WUS_MODES,
             top_k: int = 3, probe_steps: int = 3, probe_warmup: int = 1,
             include_default: bool = True,
             probe_fn=None) -> TunedConfig:
    """Pick the configuration for ``net`` on ``devices`` chips within
    ``hbm_budget`` bytes per chip. Returns a
    :class:`~deeplearning4j_tpu_torch.autotune.config.TunedConfig` the
    trainers and the serving gateway accept directly (``tuned=``).

    ``devices``: the rank count to plan for (the process group's world by
    default). ``batch``: an example DataSet for the FLOP census and the probes
    (synthesized deterministically from the config when omitted — for
    BOTH config kinds: graph configs synthesize per-input features and
    per-head one-hot labels from their declared/resolved types, a
    MultiDataSet when the graph is multi-input/-output).
    ``global_batch``: the training batch size the search plans for
    (default: the example batch's row count).
    ``top_k``: how many analytically-best candidates get a measured
    probe; 0 skips probing entirely (analytic winner, no calibration).
    ``probe_fn``: measurement injection seam (tests) — same signature
    and return shape as ``autotune.probe.measure_candidate``.
    """
    from deeplearning4j_tpu_torch.autotune import probe as probe_mod
    from deeplearning4j_tpu_torch.profiling.metrics import get_registry

    t_start = time.perf_counter()
    device_list, n_devices = _resolve_devices(devices)
    if batch is None:
        batch = probe_mod.synthesize_batch(net.conf,
                                           int(global_batch or 32))
    B = int(global_batch or batch.num_examples())
    if batch.num_examples() != B:
        # probes train `batch`, but legality/prediction/selection plan
        # for B — a mismatch would measure one workload while choosing
        # for another, so every gap (and the winner) would be fiction
        raise AutotuneError(
            f"example batch has {batch.num_examples()} rows but "
            f"global_batch={B}; pass a batch of exactly the planned "
            "size (or omit one of the two)")
    census = cost_model.census_from_net(net, batch)
    hw = cost_model.Hardware.detect(net.device)
    survivors, counters = analytic_search(
        census, n_devices, B, hbm_budget=hbm_budget,
        accum_choices=accum_choices, precisions=precisions,
        wus_modes=wus_modes, hardware=hw)
    if not survivors:
        raise AutotuneError(
            f"no legal configuration for {n_devices} device(s), "
            f"batch {B}, hbm_budget={hbm_budget}: "
            f"{counters['pruned_illegal']} illegal, "
            f"{counters['pruned_hbm']} over budget "
            f"of {counters['candidates']} candidates")

    # -- shortlist: top-K probeable + the naive default (the baseline
    # the winner must not lose to). Unprobeable analytic leaders (pp>1)
    # are counted, logged, and ranked on prediction alone.
    by_cand = {c: p for c, p in survivors}
    shortlist: List[Candidate] = []
    unprobeable = 0
    for cand, _ in survivors:
        if len(shortlist) >= max(0, top_k):
            break
        if not cand.probeable:
            unprobeable += 1
            continue
        shortlist.append(cand)
    if include_default and top_k > 0:
        default = cfg_space.default_candidate(n_devices, B)
        if default in by_cand and default not in shortlist:
            shortlist.append(default)
    if unprobeable:
        logger.info("autotune: %d analytically-ranked candidate(s) "
                    "not probeable (pp > 1); ranked on prediction only",
                    unprobeable)

    # -- probes: measure, record the gap per config
    measure = probe_fn or probe_mod.measure_candidate
    probes: List[Tuple[Candidate, ProbeRecord]] = []
    reg = get_registry()
    for cand in shortlist:
        predicted = by_cand[cand]["step_s"]
        try:
            m = measure(net, cand, batch, steps=probe_steps,
                        warmup=probe_warmup, devices=device_list)
            times = (float(m["measured_step_s"]),
                     float(m.get("compile_s", 0.0)))
        except Exception as e:  # noqa: BLE001 — one bad probe must not
            # kill the run; the other ranks learn of it from the reduction
            logger.warning("autotune: probe %s failed: %r", cand.slug(), e)
            times = (float("inf"), float("inf"))
        # the slowest rank's seconds: every rank picks the same winner
        measured, compile_s = _max_over_ranks(times)
        if measured == float("inf"):
            continue
        gap = measured / predicted if predicted > 0 else float("inf")
        rec = ProbeRecord(config=cand.slug(),
                          predicted_step_s=predicted,
                          measured_step_s=measured,
                          measured_vs_predicted_gap=gap,
                          compile_s=compile_s)
        probes.append((cand, rec))
        reg.gauge(f"autotune_gap_{cand.slug()}",
                  help="measured/predicted step time of one probed "
                       "config (cost-model calibration)").set(gap)

    # -- winner: best measured when probes ran, else analytic best
    if probes:
        winner, winner_rec = min(
            probes, key=lambda cr: (cr[1].measured_step_s,
                                    cr[0].sort_key()))
    else:
        if top_k > 0:
            logger.warning("autotune: no probe completed; falling back "
                           "to the analytic winner uncalibrated")
        winner, winner_rec = survivors[0][0], None
    predicted = by_cand[winner]

    counters["probes"] = len(probes)
    counters["unprobeable"] = unprobeable
    counters["survivors"] = len(survivors)
    tuned = TunedConfig(
        dp=winner.dp, tp=winner.tp, pp=winner.pp, sp=winner.sp,
        gradient_accumulation=winner.gradient_accumulation,
        precision=winner.precision,
        weight_update_sharding=winner.weight_update_sharding,
        global_batch=B, device_count=n_devices,
        hbm_budget_bytes=hbm_budget,
        serve_buckets=cfg_space.serve_bucket_set(B),
        predicted_step_s=predicted["step_s"],
        measured_step_s=(winner_rec.measured_step_s
                         if winner_rec else None),
        measured_vs_predicted_gap=(winner_rec.measured_vs_predicted_gap
                                   if winner_rec else None),
        predicted_hbm_bytes=predicted["hbm_bytes"],
        predicted_mfu=predicted["mfu"],
        probes=[rec for _, rec in probes],
        search=dict(counters))

    # -- observability: the search and its calibration on /api/metrics
    reg.counter("autotune_searches_total",
                help="autotune() runs completed").inc()
    reg.counter("autotune_candidates_total",
                help="configurations enumerated across searches"
                ).inc(counters["candidates"])
    reg.counter("autotune_pruned_illegal_total",
                help="candidates rejected by graphcheck legality"
                ).inc(counters["pruned_illegal"])
    reg.counter("autotune_pruned_hbm_total",
                help="candidates rejected by the HBM budget"
                ).inc(counters["pruned_hbm"])
    reg.counter("autotune_probes_total",
                help="measured probes executed").inc(len(probes))
    reg.gauge("autotune_best_predicted_step_s",
              help="winner's analytic seconds/step"
              ).set(predicted["step_s"])
    if winner_rec is not None:
        reg.gauge("autotune_best_measured_step_s",
                  help="winner's measured probe seconds/step"
                  ).set(winner_rec.measured_step_s)
        reg.gauge("autotune_measured_vs_predicted_gap",
                  help="winner's measured/predicted step-time ratio "
                       "(the cost-model calibration headline)"
                  ).set(winner_rec.measured_vs_predicted_gap)
    logger.info("autotune: %s in %.1fs (%s)", winner.slug(),
                time.perf_counter() - t_start,
                ", ".join(f"{k}={v}" for k, v in sorted(counters.items())))
    return tuned
