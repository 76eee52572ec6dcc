"""Memory planning from a config alone (the JAX package's
``analysis/memory.py``): parameter counts and a device-memory estimate,
with no tensor allocated (param shapes come from each layer's
``init_params`` run on the ``meta`` device, the counterpart of
``jax.eval_shape``), and the sizing rule of the serving engine's paged
KV pool.

The model of a training step, per replica:

- params:        P * dtype_bytes
- gradients:     P * dtype_bytes              (live during the update)
- updater state: P * dtype_bytes * K          (K from the updater family)
- activations:   the layers' outputs * batch * dtype_bytes (all kept for
                 the backward; under ``remat`` only the two largest)
- workspace:     the largest single layer's in + out + params, the
                 working-set pressure proxy (``vmem_pressure``).

Every byte count is the JAX package's. The budgets are the card's: the
default device-memory budget is the H100's, and the working set is held
against its L2 cache (the TPU's 16 MiB VMEM has no counterpart here).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# updater family -> per-param slots of persistent optimizer state
# (adam keeps m+v, rmsprop/adagrad/adadelta keep 1-2 accumulators,
# nesterovs keeps velocity, plain sgd keeps nothing)
UPDATER_STATE_SLOTS = {
    "sgd": 0, "none": 0,
    "nesterovs": 1, "adagrad": 1, "rmsprop": 1,
    "adadelta": 2, "adam": 2, "adamax": 2,
}

DTYPE_BYTES = {
    "float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
    "int32": 4, "int8": 1,
}

#: ``torch.cuda.get_device_properties(0).total_memory`` of an "NVIDIA H100
#: 80GB HBM3", measured once on the card (chip_smoke.py's ``analysis``
#: phase checks it): graphcheck's default per-card budget (GC007). A
#: constant, so that a validator's verdict does not depend on the box
#: that runs it
DEFAULT_HBM_BYTES = 85_017_493_504
#: the same card's L2 cache (``L2_cache_size``, 50 MiB). The TPU kernels
#: tile through 16 MiB of VMEM per core, which the card has no
#: counterpart of; the L2 is the on-chip level a layer's working set
#: stays resident in between kernels, so ``vmem_pressure`` divides by it
L2_BYTES = 52_428_800


def _dtype_bytes(dtype: str) -> int:
    return DTYPE_BYTES.get(str(dtype), 4)


def param_shapes(layer, name_hint: str = "") -> Dict[str, Tuple[int, ...]]:
    """Shapes of a layer's params WITHOUT allocating them: ``init_params``
    run on the ``meta`` device, where a tensor has a shape and no
    storage."""
    if not layer.has_params():
        return {}
    with torch.device("meta"):
        params = layer.init_params(torch.Generator())
    return {k: tuple(v.shape) for k, v in params.items()}


def param_count(layer) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(layer).values())


@dataclass
class LayerMemoryEntry:
    """One row of the report (ref: LayerMemoryReport)."""
    name: str
    layer_type: str
    n_params: int
    activation_shape: Tuple[int, ...]   # per example, batch dim excluded
    activation_elems: int               # per example

    def row(self) -> str:
        shape = "x".join(str(d) for d in self.activation_shape) or "-"
        return (f"  {self.name:<28} {self.layer_type:<24} "
                f"{self.n_params:>12,} {shape:>16}")


@dataclass
class MemoryReport:
    """The aggregated estimate; ``to_text()`` renders the per-layer table
    and the standing / working split.

    ``weight_update_sharding="zero1"`` with ``dp``: the updater-state term
    is ZeRO-1's, each replica holding ``replicated / dp`` of it (the
    trainers' flattened pad-to-divisible rows; the <= dp elements of
    padding a leaf are below this estimate's resolution, and graphcheck
    flags waste of note). ``"zero2"`` divides the gradient term by ``dp``
    too: the reduced gradient lives as this rank's row only, where zero1
    keeps a replicated anchor before slicing."""
    entries: List[LayerMemoryEntry] = field(default_factory=list)
    batch_size: int = 32
    dtype: str = "float32"
    updater: str = "sgd"
    remat: bool = False
    weight_update_sharding: str = "off"
    dp: int = 1
    # token-level serving: the block-paged KV pool a ``decode_rows``-row
    # engine allocates, its bytes, page length and page count those of
    # ``kv_pool_plan`` (the engine's own sizing rule)
    decode_rows: int = 0
    kv_cache_total_bytes: int = 0
    kv_page_len: int = 0
    kv_pages_total: int = 0
    kv_pages_per_row: int = 0

    # ------------------------------------------------------------ aggregates
    @property
    def total_params(self) -> int:
        return sum(e.n_params for e in self.entries)

    @property
    def param_bytes(self) -> int:
        return self.total_params * _dtype_bytes(self.dtype)

    @property
    def updater_state_shards(self) -> int:
        """How many ways the updater state is split (1 = replicated)."""
        from deeplearning4j_tpu_torch.analysis.graphcheck import (
            SHARDED_WUS_MODES,
        )
        if self.weight_update_sharding in SHARDED_WUS_MODES and self.dp > 1:
            return self.dp
        return 1

    @property
    def updater_state_bytes(self) -> int:
        slots = UPDATER_STATE_SLOTS.get(self.updater, 2)
        return -(-self.param_bytes * slots // self.updater_state_shards)

    @property
    def gradient_shards(self) -> int:
        """How many ways the reduced gradient is split: ``dp`` under zero2
        only (zero1 anchors a whole replicated gradient before slicing
        it into the sharded accumulator)."""
        if self.weight_update_sharding == "zero2" and self.dp > 1:
            return self.dp
        return 1

    @property
    def gradient_bytes(self) -> int:
        return -(-self.param_bytes // self.gradient_shards)

    @property
    def activation_bytes(self) -> int:
        per_ex = [e.activation_elems for e in self.entries]
        if not per_ex:
            return 0
        if self.remat:
            # only the live boundary pair is stored; backward recomputes
            per_ex = sorted(per_ex)[-2:]
        return sum(per_ex) * self.batch_size * _dtype_bytes(self.dtype)

    @property
    def total_hbm_bytes(self) -> int:
        return (self.param_bytes + self.updater_state_bytes
                + self.gradient_bytes + self.activation_bytes)

    @property
    def peak_layer_working_set_bytes(self) -> int:
        """The largest single layer's in + out + params footprint."""
        peak = 0
        prev_elems = 0
        db = _dtype_bytes(self.dtype)
        for e in self.entries:
            ws = (prev_elems + e.activation_elems) * self.batch_size * db \
                + e.n_params * db
            peak = max(peak, ws)
            prev_elems = e.activation_elems
        return peak

    def vmem_pressure(self) -> float:
        """The peak working set as a multiple of the card's L2 cache
        (``L2_BYTES``): above 1 a layer's operands cannot stay on chip
        between its kernels and stream from device memory. The name is
        the JAX package's, whose budget is the TPU core's VMEM."""
        return self.peak_layer_working_set_bytes / L2_BYTES

    # ---------------------------------------------------------------- render
    def to_text(self) -> str:
        def mb(b: int) -> str:
            return f"{b / (1024 ** 2):,.1f} MiB"

        lines = [
            f"MemoryReport  (batch={self.batch_size}, dtype={self.dtype}, "
            f"updater={self.updater}, remat={self.remat})",
            f"  {'layer':<28} {'type':<24} {'params':>12} {'act/ex':>16}",
        ]
        lines += [e.row() for e in self.entries]
        lines += [
            f"  total params:        {self.total_params:,}",
            f"  params:              {mb(self.param_bytes)}",
            f"  gradients:           {mb(self.gradient_bytes)}"
            + (f" (zero2: 1/{self.gradient_shards} per replica)"
               if self.gradient_shards > 1 else ""),
            f"  updater state:       {mb(self.updater_state_bytes)} "
            f"({UPDATER_STATE_SLOTS.get(self.updater, 2)} slot(s)"
            + (f", {self.weight_update_sharding}: "
               f"1/{self.updater_state_shards} per replica"
               if self.updater_state_shards > 1 else "") + ")",
            f"  activations:         {mb(self.activation_bytes)}"
            + (" (remat: boundary pair only)" if self.remat else ""),
            f"  est. HBM (train):    {mb(self.total_hbm_bytes)}",
            f"  peak layer wset:     {mb(self.peak_layer_working_set_bytes)}"
            f"  ({self.vmem_pressure():.1f}x L2)",
        ]
        if self.decode_rows:
            lines.append(
                f"  KV cache (serve):    {mb(self.kv_cache_total_bytes)}"
                f"  page pool ({self.kv_pages_total} pages x "
                f"{self.kv_page_len} tok, {self.kv_pages_per_row} "
                f"pages/row, {self.decode_rows} decode rows: the "
                "page-granular eviction budget; shared prefix pages "
                "dedup below this ceiling)")
        return "\n".join(lines)


def default_kv_page_len(max_len: int) -> int:
    """Default KV page length for a ``max_len``-position decode row:
    the largest divisor of ``max_len`` no bigger than ``max_len // 4``
    (4+ pages per row keeps page-granular eviction meaningful), floor
    1. Pages must DIVIDE ``max_len`` so a row's page chain gathers back
    into the exact dense cache shape."""
    p = max(1, int(max_len) // 4)
    while int(max_len) % p:
        p -= 1
    return p


def _decode_max_len(conf, layers) -> int:
    """The graph-wide static cache length, as the container's
    ``decode_max_len`` resolves it: a layer's position-table capacity
    wins over the input types' timesteps. 0: not a decoder (a stack,
    whose ``input_types`` is a list, decodes nothing; the JAX package's
    walk raises there)."""
    for _name, layer, _out in layers:
        if getattr(layer, "max_timesteps", 0):
            return int(layer.max_timesteps)
    types = getattr(conf, "input_types", None)
    for t in (types.values() if isinstance(types, dict) else ()):
        if t is not None and t.kind == "rnn" and t.timesteps:
            return int(t.timesteps)
    return 0


def kv_page_group_bytes(conf, page_len: Optional[int] = None) -> int:
    """Config-only bytes of ONE KV page group: k + v over ``page_len``
    positions across every causal attention layer, the allocation and
    eviction unit of the paged serving pool. 0 for a config with no
    causal attention."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        iter_config_layers,
    )
    db = _dtype_bytes(conf.training.dtype)
    layers = list(iter_config_layers(conf))
    ml = _decode_max_len(conf, layers)
    if not ml:
        return 0
    pl = default_kv_page_len(ml) if page_len is None else int(page_len)
    total = 0
    for _name, layer, _out in layers:
        if not getattr(layer, "causal", False) \
                or not hasattr(layer, "cache_shape"):
            continue
        total += 2 * int(np.prod(layer.cache_shape(1, pl))) * db
    return total


@dataclass
class KVPoolPlan:
    """The paged KV pool the serving engine allocates for a config: the
    one sizing rule ``memory_report`` and the live engine
    (``keras/generation.py``) share.

    ``pages``: usable pages = ``min(max_rows * pages_per_row,
    budget_bytes // page_group_bytes)``. ``total_pages`` adds the one
    reserved scratch page (physical page 0, which unmapped page-table
    slots alias). ``total_bytes`` is the resident pool, the
    ``serving_kv_cache_bytes`` gauge."""
    page_len: int
    pages_per_row: int
    page_group_bytes: int
    pages: int

    @property
    def total_pages(self) -> int:
        return self.pages + 1

    @property
    def total_bytes(self) -> int:
        return self.total_pages * self.page_group_bytes


def kv_pool_plan(conf, max_rows: int,
                 budget_bytes: Optional[int] = None,
                 page_len: Optional[int] = None) -> KVPoolPlan:
    """Size the block-paged KV pool for ``max_rows`` decode rows under an
    optional byte budget. Raises for a config with no causal attention
    and for a budget that cannot hold one page group, as the engine
    does."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        iter_config_layers,
    )
    layers = list(iter_config_layers(conf))
    ml = _decode_max_len(conf, layers)
    if not ml:
        raise ValueError("config has no causal attention — no KV pool")
    pl = default_kv_page_len(ml) if page_len is None else int(page_len)
    if pl < 1 or ml % pl:
        raise ValueError(f"kv page_len {pl} must divide max_len {ml}")
    pgb = kv_page_group_bytes(conf, pl)
    ppr = ml // pl
    pages = max(1, int(max_rows)) * ppr
    if budget_bytes is not None:
        pages = min(pages, int(budget_bytes) // pgb)
    if pages < 1:
        raise ValueError(
            f"cache_budget_bytes={budget_bytes} cannot hold even one "
            f"KV page group ({pgb} bytes/page-group)")
    return KVPoolPlan(page_len=pl, pages_per_row=ppr,
                      page_group_bytes=pgb, pages=pages)


def kv_cache_bytes(conf, rows: int, max_len: Optional[int] = None,
                   page_len: Optional[int] = None,
                   pages: Optional[int] = None) -> int:
    """Config-only bytes of the serving KV residency, page-granular: a
    row resident to position p holds ``ceil((p+1) / page_len)`` page
    groups. ``pages`` given: exactly that many page groups (a live
    pool's gauge); else ``rows`` full rows, ``rows * (max_len /
    page_len)`` page groups. 0 for a config with no causal attention."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        iter_config_layers,
    )
    layers = list(iter_config_layers(conf))
    ml = max_len if max_len is not None else _decode_max_len(conf, layers)
    if not ml:
        return 0
    pl = default_kv_page_len(ml) if page_len is None else int(page_len)
    pgb = kv_page_group_bytes(conf, pl)
    if pages is None:
        pages = rows * (-(-int(ml) // pl))
    return int(pages) * pgb


def memory_report(conf, batch_size: int = 32, layers=None,
                  weight_update_sharding: str = "off",
                  dp: int = 1, decode_rows: int = 0) -> MemoryReport:
    """A MemoryReport for either configuration type. Needs a config whose
    shapes resolve (input types set); a layer whose params cannot be
    shaped counts zero (graphcheck reports it). ``layers``: the (name,
    layer conf, output type) triples a validation pass already inferred.
    ``weight_update_sharding`` / ``dp``: the ZeRO layouts' terms
    (:class:`MemoryReport`). ``decode_rows``: the serving engine's KV pool
    at that many decode rows, ``kv_pool_plan(conf, decode_rows)``'s bytes,
    page length and page count (the engine's gauge at
    ``max_rows=decode_rows``)."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        iter_config_layers,
    )
    training = conf.training
    rep = MemoryReport(batch_size=batch_size, dtype=training.dtype,
                       updater=training.updater.name,
                       remat=getattr(training, "remat", False),
                       weight_update_sharding=weight_update_sharding,
                       dp=max(1, int(dp)),
                       decode_rows=max(0, int(decode_rows)))
    if rep.decode_rows:
        try:
            plan = kv_pool_plan(conf, rep.decode_rows)
        except ValueError:   # no causal attention: nothing decodes
            plan = None
        if plan is not None:
            rep.kv_cache_total_bytes = plan.total_bytes
            rep.kv_page_len = plan.page_len
            rep.kv_pages_total = plan.total_pages
            rep.kv_pages_per_row = plan.pages_per_row
    for name, layer, out_type in (layers if layers is not None
                                  else iter_config_layers(conf)):
        try:
            n = param_count(layer)
        except Exception:
            n = 0
        shape = out_type.example_shape() if out_type is not None else ()
        rep.entries.append(LayerMemoryEntry(
            name=name, layer_type=type(layer).__name__, n_params=n,
            activation_shape=tuple(shape),
            activation_elems=int(np.prod(shape)) if shape else 0))
    return rep
