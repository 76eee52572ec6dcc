"""Configuration search space: the legal knobs the autotuner sweeps (the
JAX package's ``autotune/space.py``, copied).

A :class:`Candidate` is one complete training configuration — mesh shape
(dp x tp x pp x sp over ALL devices), microbatching
(``gradient_accumulation``), precision preset, and
``weight_update_sharding`` mode — in the exact vocabulary the trainers
take, so a candidate is constructible without translation
(:meth:`Candidate.trainer_kwargs`).

:func:`enumerate_space` is pure combinatorics; it applies only the
constraints that are STRUCTURAL (the mesh must use every device, the
microbatch split must divide the per-replica batch — the trainer's own
``B % accum`` step-time requirement). Everything graphcheck already
rules on (dp divisibility GC008, zero1/zero2 mesh legality GC011,
precision legality GC015, elastic plans GC014) is deliberately NOT
re-implemented here: the tuner prunes candidates by running
``analysis.graphcheck.validate_config`` and discarding any candidate
with an ERROR finding (see ``autotune/tuner.py``), so the search can
never disagree with the validator about what is legal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

#: precision presets the sweep considers by default (fp16 needs a loss
#: scale to be safe and is opt-in via ``precisions=``)
DEFAULT_PRECISIONS = ("fp32", "bf16")

#: weight-update layouts the sweep considers (parallel.mesh
#: WeightUpdateSharding.MODES minus nothing — all three are probe-able)
DEFAULT_WUS_MODES = ("off", "zero1", "zero2")

#: gradient-accumulation (microbatch) choices
DEFAULT_ACCUM = (1, 2, 4)

#: serving bucket sets never exceed this many rows per compiled bucket
SERVE_MAX_BATCH_CAP = 128


@dataclass(frozen=True)
class Candidate:
    """One point of the search space, in trainer vocabulary."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    gradient_accumulation: int = 1
    precision: str = "fp32"
    weight_update_sharding: str = "off"

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.pp * self.sp

    @property
    def mesh_axes(self) -> Dict[str, int]:
        """The dict form graphcheck's ``mesh=`` kwarg takes."""
        axes = {"dp": self.dp}
        if self.tp > 1:
            axes["tp"] = self.tp
        if self.pp > 1:
            axes["pp"] = self.pp
        if self.sp > 1:
            axes["sp"] = self.sp
        return axes

    @property
    def probeable(self) -> bool:
        """True when ``ParallelTrainer`` can run this candidate as one
        SPMD step (pp > 1 needs the pipeline trainer's schedule and is
        ranked analytically only)."""
        return self.pp == 1

    def slug(self) -> str:
        """Stable metric/log key: ``dp2_ga4_bf16_zero1`` (axes at 1 and
        defaults omitted so the common shapes stay readable)."""
        parts = [f"dp{self.dp}"]
        for name in ("tp", "pp", "sp"):
            v = getattr(self, name)
            if v > 1:
                parts.append(f"{name}{v}")
        parts.append(f"ga{self.gradient_accumulation}")
        parts.append(self.precision)
        parts.append(self.weight_update_sharding)
        return "_".join(parts)

    def trainer_kwargs(self) -> dict:
        """The ``ParallelTrainer`` kwargs (minus mesh) this candidate
        prescribes — the one construction recipe ``TunedConfig`` and the
        probe harness share, so a tuned trainer and a hand-built one
        cannot drift."""
        return dict(gradient_accumulation=self.gradient_accumulation,
                    weight_update_sharding=self.weight_update_sharding,
                    precision=self.precision)

    def sort_key(self) -> tuple:
        """Deterministic tiebreak for equal predicted step times: prefer
        the simplest shape (pure dp before tp/sp/pp, no accumulation,
        fp32 before half, replicated before sharded updates) — the
        config with the fewest moving parts wins a tie."""
        return (self.pp, self.sp, self.tp,
                self.gradient_accumulation,
                DEFAULT_PRECISIONS.index(self.precision)
                if self.precision in DEFAULT_PRECISIONS else 99,
                DEFAULT_WUS_MODES.index(self.weight_update_sharding)
                if self.weight_update_sharding in DEFAULT_WUS_MODES else 99,
                -self.dp)


def mesh_shapes(n_devices: int) -> List[Tuple[int, int, int, int]]:
    """Every (dp, tp, pp, sp) factorization using EXACTLY ``n_devices``
    chips. Idle chips are never optimal for a fixed fleet, and the naive
    default the tuner measures against (``MeshContext.create()``) also
    uses them all."""
    n = max(1, int(n_devices))
    shapes = []
    for dp in range(1, n + 1):
        if n % dp:
            continue
        rem_dp = n // dp
        for tp in range(1, rem_dp + 1):
            if rem_dp % tp:
                continue
            rem_tp = rem_dp // tp
            for pp in range(1, rem_tp + 1):
                if rem_tp % pp:
                    continue
                shapes.append((dp, tp, pp, rem_tp // pp))
    return shapes


def enumerate_space(n_devices: int, global_batch: int,
                    accum_choices: Sequence[int] = DEFAULT_ACCUM,
                    precisions: Sequence[str] = DEFAULT_PRECISIONS,
                    wus_modes: Sequence[str] = DEFAULT_WUS_MODES,
                    ) -> Iterator[Candidate]:
    """Yield every structurally-possible candidate, deterministically
    ordered. Structural filters only (see module docstring): the
    GLOBAL batch must split into ``accum`` whole microbatches — the
    trainer's own step-time ``B % accum`` requirement — and must
    cover the dp axis at all. Legality proper (graphcheck) is the
    tuner's job."""
    for dp, tp, pp, sp in mesh_shapes(n_devices):
        if global_batch < dp:
            continue
        for accum in accum_choices:
            if global_batch % max(1, accum):
                continue
            for precision in precisions:
                for wus in wus_modes:
                    yield Candidate(
                        dp=dp, tp=tp, pp=pp, sp=sp,
                        gradient_accumulation=int(accum),
                        precision=str(precision),
                        weight_update_sharding=str(wus))


def default_candidate(n_devices: int, global_batch: int) -> Candidate:
    """The config a user gets WITHOUT tuning: ``MeshContext.create()``
    puts every rank on the data axis, no accumulation, fp32,
    replicated weight update. Falls back to dp=1 when the global batch
    cannot shard that wide (the same degradation the untuned path hits
    at step time). This is the baseline every autotune run probes —
    the winner must measure no slower than it."""
    dp = int(n_devices)
    if dp < 1 or (global_batch and global_batch % dp):
        dp = 1
    return Candidate(dp=dp)


def serve_bucket_set(global_batch: int, max_batch_cap: int
                     = SERVE_MAX_BATCH_CAP) -> Tuple[int, ...]:
    """The power-of-two serving bucket set implied by a tuned training
    batch: buckets up to the largest pow2 <= max(global_batch, 1),
    capped. The KerasServer batching scheduler captures one CUDA graph per
    bucket — this is the set a warmed gateway holds."""
    from deeplearning4j_tpu_torch.util.math_utils import next_pow_of_2
    top = max(1, min(int(max_batch_cap), int(global_batch) or 1))
    p = next_pow_of_2(top)
    if p > top:
        p >>= 1
    buckets, b = [], 1
    while b <= p:
        buckets.append(b)
        b <<= 1
    return tuple(buckets)
