"""TunedConfig: the autotuner's output, in a form every consumer takes
(the JAX package's ``autotune/config.py``; the JSON is the same, so a
config either package writes loads in the other).

One object carries the chosen training layout (mesh shape dp x tp x pp
x sp, gradient accumulation, precision preset, weight-update sharding),
the serving bucket set the same budget implies, and the calibration
evidence (every probed config's predicted vs measured step time and the
``measured_vs_predicted_gap``). It serializes to JSON so a tuned config
can be CHECKED IN next to the model and rebuilt bit-for-bit later —
probe parity
(``tests/test_torch_autotune.py``, ``chip_smoke.py``'s ``cost_autotune``
phase) guarantees a trainer built from a ``TunedConfig`` trains bitwise
identically to one hand-built with the same knobs, because
``trainer_kwargs`` is the single construction recipe both paths share.

Consumers (all accept ``tuned=``):

- ``parallel.ParallelTrainer`` / ``parallel.ParallelWrapper``
- ``parallel.multihost.data_parallel_trainer``
- ``keras.server.KerasServer`` (batching scheduler ``max_batch`` = the
  top tuned bucket)
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.autotune.space import Candidate


@dataclass(frozen=True)
class ProbeRecord:
    """One measured probe: what the model predicted, what the card (or
    CPU) measured, and the gap — the per-config calibration surface."""
    config: str                    # Candidate.slug()
    predicted_step_s: float
    measured_step_s: float
    measured_vs_predicted_gap: float   # measured / predicted
    compile_s: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ProbeRecord":
        return ProbeRecord(**d)


@dataclass
class TunedConfig:
    """The winning configuration plus its evidence."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    gradient_accumulation: int = 1
    precision: str = "fp32"
    weight_update_sharding: str = "off"
    global_batch: int = 32
    device_count: int = 1
    hbm_budget_bytes: Optional[int] = None
    serve_buckets: Tuple[int, ...] = (1,)
    # calibration outputs
    predicted_step_s: Optional[float] = None
    measured_step_s: Optional[float] = None
    measured_vs_predicted_gap: Optional[float] = None
    predicted_hbm_bytes: Optional[int] = None
    predicted_mfu: Optional[float] = None
    probes: List[ProbeRecord] = field(default_factory=list)
    # search bookkeeping (how the space shrank — serialized so a
    # checked-in config documents what was ruled out and why)
    search: Dict[str, int] = field(default_factory=dict)

    FORMAT = "TunedConfig.v1"

    # ----------------------------------------------------------- derived
    @property
    def candidate(self) -> Candidate:
        return Candidate(
            dp=self.dp, tp=self.tp, pp=self.pp, sp=self.sp,
            gradient_accumulation=self.gradient_accumulation,
            precision=self.precision,
            weight_update_sharding=self.weight_update_sharding)

    @property
    def serve_max_batch(self) -> int:
        return max(self.serve_buckets) if self.serve_buckets else 1

    def mesh_context(self, device=None):
        """The MeshContext this config prescribes over the default process
        group, on ``device`` (pp excluded: the pipeline trainer owns stage
        placement)."""
        from deeplearning4j_tpu_torch.parallel.mesh import MeshContext
        if self.pp > 1:
            raise ValueError(
                f"TunedConfig with pp={self.pp} maps to the pipeline "
                "trainer, not a flat MeshContext; build a "
                "PipelineTrainer from .candidate explicitly")
        return MeshContext.create(n_data=self.dp, n_model=self.tp,
                                  n_seq=self.sp, device=device)

    def trainer_kwargs(self) -> dict:
        """ParallelTrainer kwargs (minus mesh) — delegated to the
        candidate so TunedConfig and the probe harness can never
        construct differently."""
        return self.candidate.trainer_kwargs()

    def trainer(self, net, device=None, **kwargs):
        """One-call trainer at the tuned config, its mesh on ``device``
        (the net's by default): ``autotune(net).trainer(net).fit(...)``."""
        from deeplearning4j_tpu_torch.parallel.trainer import ParallelTrainer
        return ParallelTrainer(
            net, self.mesh_context(device=device if device is not None
                                   else net.device),
            tuned=self, **kwargs)

    # ------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        d = asdict(self)
        d["format"] = self.FORMAT
        d["serve_buckets"] = list(self.serve_buckets)
        d["probes"] = [p.to_dict() if isinstance(p, ProbeRecord) else dict(p)
                       for p in self.probes]
        return d

    @staticmethod
    def from_dict(d: dict) -> "TunedConfig":
        d = dict(d)
        fmt = d.pop("format", TunedConfig.FORMAT)
        if fmt != TunedConfig.FORMAT:
            raise ValueError(f"unsupported TunedConfig format {fmt!r}")
        d["serve_buckets"] = tuple(d.get("serve_buckets", (1,)))
        d["probes"] = [ProbeRecord.from_dict(p)
                       for p in d.get("probes", [])]
        d["search"] = dict(d.get("search", {}))
        return TunedConfig(**d)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "TunedConfig":
        return TunedConfig.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        """Atomic write (resilience/atomic.py — a torn tuned config
        must never be half-loaded into a fleet)."""
        from deeplearning4j_tpu_torch.resilience.atomic import (
            atomic_write_bytes,
        )
        atomic_write_bytes(path, (self.to_json() + "\n").encode())

    @staticmethod
    def load(path: str) -> "TunedConfig":
        with open(path, "r", encoding="utf-8") as fh:
            return TunedConfig.from_json(fh.read())

    # ------------------------------------------------------------ display
    def summary(self) -> str:
        lines = [
            f"TunedConfig  (devices={self.device_count}, "
            f"batch={self.global_batch})",
            f"  mesh: dp={self.dp} tp={self.tp} pp={self.pp} sp={self.sp}"
            f"  accum={self.gradient_accumulation}"
            f"  precision={self.precision}"
            f"  wus={self.weight_update_sharding}",
            f"  serve buckets: {list(self.serve_buckets)}",
            f"  predicted {self.predicted_step_s!r} s/step, "
            f"measured {self.measured_step_s!r} s/step, "
            f"gap {self.measured_vs_predicted_gap!r}",
        ]
        if self.search:
            lines.append("  search: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.search.items())))
        for p in self.probes:
            lines.append(
                f"    probe {p.config:<28} predicted {p.predicted_step_s:.5f}s"
                f" measured {p.measured_step_s:.5f}s"
                f" gap {p.measured_vs_predicted_gap:.2f}x")
        return "\n".join(lines)
