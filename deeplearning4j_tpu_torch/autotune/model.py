"""Analytic step-time / MFU model the autotuner ranks candidates with (the
JAX package's ``autotune/model.py``), re-costed for the card.

Built from numbers the port already predicts: a training step's FLOP
count (``profiling/cost.train_step_cost``), the ring-model collective
bytes (``profiling/cost.dp_comm_bytes_per_update``) and the MemoryReport
walk (``analysis/memory``, whose byte counts are the JAX package's),
composed into one seconds-per-step estimate per candidate:

    step_s = (compute_s + comm_s) * pipeline_bubble

- ``compute_s``: the step's FLOPs split over the ranks that share the
  work (dp, tp, pp always split compute; sp splits it only when the model
  has an attention layer to ring over), at the device's product rate for
  the candidate's compute dtype.
- ``comm_s``: the dp gradient exchange (the exact ring model), plus
  first-order activation-exchange terms for tp/sp and boundary transfers
  for pp, at the process group's link rate.
- ``pipeline_bubble``: the GPipe factor ``(pp - 1 + m) / m`` with
  ``m = gradient_accumulation`` microbatches.

This is a RANKING model, not a stopwatch: the measured probes expose its
absolute error, and each probe's ``measured_vs_predicted_gap`` is the
calibration surface.

Two census sources feed it:

- :func:`census_from_net`: an initialized container: its exact param
  count (memoized, ``profiling/cost.param_census``) and the FLOPs of a
  real step counted on its device (memoized on the batch signature). A
  failure of the count raises: falling back to the parameter estimate
  would hide a broken counter.
- :func:`census_from_conf`: a bare config (graphcheck's GC016 path): the
  param count from the MemoryReport walk and FLOPs estimated at
  :data:`FLOPS_PER_PARAM` per example, the same on both sides of a GC016
  comparison.

The card's constants (:meth:`Hardware.detect`): the peak is the cost
table's for ``torch.cuda.get_device_name()``; the port's f32 products run
as 3xTF32 on the tensor cores, so fp32 runs at :data:`H100_F32_FRACTION`
of the bf16 peak; the link rate is the process group's backend's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.profiling.cost import (
    H100_BF16_FLOPS, H100_TF32_FLOPS,
)

#: fwd+bwd+update FLOPs per parameter per example for the config-only
#: census (2 MAC-FLOPs forward per param, x3 for the backward pair) —
#: the standard dense-model rule of thumb
FLOPS_PER_PARAM = 6.0

#: fraction of a device's (bf16) peak that fp32 products achieve on an
#: accelerator without a better figure (the JAX package's TPU value)...
ACCEL_FP32_FRACTION = 0.5
#: ...and the inverse on CPU, where half precision is EMULATED: the
#: tuner must never "discover" bf16 speedups a CPU probe then refutes
CPU_HALF_FRACTION = 0.5
#: the H100's: its f32 products run as 3xTF32, a third of the TF32
#: tensor-core rate, against the bf16 rate (NVIDIA's published dense
#: figures, ``profiling/cost``: 494.7 / 3 / 989.4, about 1/6)
H100_F32_FRACTION = H100_TF32_FLOPS / 3 / H100_BF16_FLOPS

#: bytes a second a rank moves through a gloo all-reduce of a
#: gradient-sized buffer between two ranks on one H100 80GB HBM3 (700 W):
#: the 101.5 MB GPT gradient's all-reduce alone took 84-149 ms in
#: chip_smoke.py's train_parallel phase (PERF.md), 0.68-1.21 GB/s
GLOO_BYTES_PER_S = 1.0e9
#: NCCL between H100 SXM cards: NVLink 4's published 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9

#: half-precision compute dtypes (graphcheck's list)
_HALF = ("bfloat16", "bf16", "float16", "fp16", "half")

#: tensor/sequence parallelism splits compute SUBLINEARLY: per-layer
#: collectives serialize against the matmuls they feed, and kernels
#: whose dims don't divide the axis stay replicated — an N-way tp axis
#: yields ~N^0.75 effective compute shards. Data and pipeline
#: parallelism stay linear (embarrassingly parallel over examples /
#: stages; pp pays its own bubble term instead).
TP_SPLIT_EXPONENT = 0.75


def link_bytes_per_s() -> float:
    """The default process group's link rate: gloo's measured one, NCCL's
    NVLink figure; NVLink's too without a group (world 1 moves
    nothing)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_backend() == "gloo":
        return GLOO_BYTES_PER_S
    return NVLINK_BYTES_PER_S


@dataclass(frozen=True)
class Hardware:
    """The per-device constants the model scales by."""
    peak_flops: float          # dense product FLOP/s at the native dtype
    ici_bytes_per_s: float     # a rank's link rate to the others
    is_accelerator: bool = True
    device_kind: str = "unknown"
    fp32_fraction: float = ACCEL_FP32_FRACTION

    def matmul_fraction(self, precision: str) -> float:
        half = str(precision or "fp32").lower() in _HALF
        if self.is_accelerator:
            return 1.0 if half else self.fp32_fraction
        return CPU_HALF_FRACTION if half else 1.0

    @staticmethod
    def detect(device=None) -> "Hardware":
        """The constants of ``device`` (the card by default): the cost
        table's peak for its name, the 3xTF32 fp32 fraction on an H100,
        the process group's link rate. Without a card (or for a CPU
        ``device``), the CPU profile: host memory's 50 GB/s as the
        link."""
        import torch
        from deeplearning4j_tpu_torch.profiling.cost import peak_flops
        cpu = device is not None and torch.device(device).type != "cuda"
        if cpu or not torch.cuda.is_available():
            return Hardware(peak_flops=peak_flops("cpu"),
                            ici_bytes_per_s=50e9, is_accelerator=False,
                            device_kind="cpu")
        kind = torch.cuda.get_device_name(device)
        return Hardware(
            peak_flops=peak_flops(kind) or 1e12,
            ici_bytes_per_s=link_bytes_per_s(), is_accelerator=True,
            device_kind=kind,
            fp32_fraction=(H100_F32_FRACTION if "h100" in kind.lower()
                           else ACCEL_FP32_FRACTION))

    @staticmethod
    def reference() -> "Hardware":
        """Fixed machine-independent constants (the CPU profile) — what
        graphcheck's GC016 compares with, so the same config gets the
        same verdict on every box. The tuner proper uses :meth:`detect` —
        its probes measure the real machine anyway."""
        return Hardware(peak_flops=1e12, ici_bytes_per_s=50e9,
                        is_accelerator=False, device_kind="reference")


@dataclass
class ModelCensus:
    """Everything the analytic model needs to know about ONE model.

    Built ONCE per search (one shape walk, one optional counted step);
    every per-candidate prediction then reuses the cached
    ``LayerMemoryEntry`` rows — a MemoryReport per candidate costs dict
    math, never another shape walk."""
    conf: object
    param_count: int
    flops_per_example: float
    dtype_bytes: int = 4
    mem_dtype: str = "float32"
    updater: str = "sgd"
    has_attention: bool = False
    n_layers: int = 1
    #: pre-walked LayerMemoryEntry rows (analysis/memory) — batch- and
    #: layout-independent, so one walk serves every candidate
    entries: List = field(default_factory=list)

    @property
    def activation_elems_per_example(self) -> int:
        return sum(e.activation_elems for e in self.entries)

    def memory_report_at(self, batch_size: int,
                         weight_update_sharding: str, dp: int):
        """A MemoryReport at one candidate's layout, from the cached
        entries (no re-walk)."""
        from deeplearning4j_tpu_torch.analysis.memory import MemoryReport
        return MemoryReport(
            entries=self.entries, batch_size=max(1, int(batch_size)),
            dtype=self.mem_dtype, updater=self.updater,
            remat=getattr(self.conf.training, "remat", False),
            weight_update_sharding=weight_update_sharding,
            dp=max(1, int(dp)))


def _base_census(conf, walk: Optional[List[Tuple]] = None) -> ModelCensus:
    from deeplearning4j_tpu_torch.analysis.graphcheck import iter_config_layers
    from deeplearning4j_tpu_torch.analysis.memory import memory_report
    if walk is None:
        walk = list(iter_config_layers(conf))
    rep = memory_report(conf, batch_size=1, layers=walk)
    return ModelCensus(
        conf=conf, param_count=rep.total_params,
        flops_per_example=FLOPS_PER_PARAM * max(rep.total_params, 1),
        mem_dtype=rep.dtype, updater=rep.updater,
        has_attention=any("Attention" in type(l).__name__
                          for _, l, _ in walk),
        n_layers=max(1, len(walk)), entries=rep.entries)


def census_from_conf(conf, walk: Optional[List[Tuple]] = None
                     ) -> ModelCensus:
    """Config-only census (no net, no compile): the GC016 path. FLOPs
    are the :data:`FLOPS_PER_PARAM` estimate — crude absolutely, but
    identical on both sides of any comparison made with it."""
    return _base_census(conf, walk)


def census_from_net(net, batch) -> ModelCensus:
    """Census from an initialized container: exact params (memoized,
    ``profiling/cost.param_census``) and the FLOPs a real step on its
    device counts (memoized on the batch signature). A failed count
    raises (the JAX package falls back to the parameter estimate)."""
    from deeplearning4j_tpu_torch.profiling.cost import (
        param_census, train_step_cost,
    )
    census = _base_census(net.conf)
    pc = param_census(net)
    census.param_count = pc["param_count"]
    census.dtype_bytes = pc["dtype_bytes"]
    census.updater = pc["updater"]
    census.flops_per_example = float(
        train_step_cost(net, batch)["flops_per_example"])
    return census


def predict(census: ModelCensus, cand, global_batch: int,
            hardware: Optional[Hardware] = None) -> Dict[str, float]:
    """Analytic cost of one :class:`~deeplearning4j_tpu_torch.autotune.space.
    Candidate`: {step_s, compute_s, comm_s, bubble, hbm_bytes, mfu}.
    Deterministic — same inputs, same floats."""
    hw = hardware or Hardware.detect()
    B = max(1, int(global_batch))
    dp, tp, pp, sp = cand.dp, cand.tp, cand.pp, cand.sp
    accum = max(1, cand.gradient_accumulation)

    # -- compute: FLOPs split over the chips that share them (tp/sp
    # split sublinearly — see TP_SPLIT_EXPONENT; sp splits nothing when
    # the model has no attention layer to ring over, so those chips
    # idle and the candidate ranks accordingly)
    sp_effective = sp if census.has_attention else 1
    compute_shards = (dp * pp * tp ** TP_SPLIT_EXPONENT
                      * sp_effective ** TP_SPLIT_EXPONENT)
    rate = hw.peak_flops * hw.matmul_fraction(cand.precision)
    compute_s = (census.flops_per_example * B) / (compute_shards * rate)

    # -- communication (per step, per chip, ring model)
    from deeplearning4j_tpu_torch.profiling.cost import dp_comm_bytes_per_update
    local_params = census.param_count // max(1, tp * pp)
    comm_bytes = dp_comm_bytes_per_update(
        local_params, dp, 4,  # gradients exchange in fp32 on every policy
        gradient_accumulation=accum,
        weight_update_sharding=cand.weight_update_sharding)
    compute_dtype_bytes = (2 if str(cand.precision).lower() in _HALF
                           else census.dtype_bytes)
    act_bytes = (census.activation_elems_per_example * (B // max(1, dp))
                 * compute_dtype_bytes)
    if tp > 1:   # fwd + bwd activation exchange per layer boundary
        comm_bytes += 2 * act_bytes * (tp - 1) // tp
    if sp_effective > 1:  # ring attention: one KV rotation each way
        comm_bytes += act_bytes * (sp_effective - 1) // sp_effective
    if pp > 1:   # microbatch boundary activations between stages
        comm_bytes += 2 * (pp - 1) * (act_bytes // census.n_layers)
    comm_s = comm_bytes / hw.ici_bytes_per_s

    # -- GPipe bubble
    bubble = (pp - 1 + accum) / accum if pp > 1 else 1.0
    step_s = (compute_s + comm_s) * bubble

    # -- per-chip HBM at this layout (MemoryReport from the cached
    # entries): the params/grads/updater terms additionally divide over
    # tp*pp (each chip holds only its kernel/stage shard); activations
    # scale with the per-microbatch slice and the compute dtype
    micro = max(1, B // max(1, dp * accum))
    rep = census.memory_report_at(
        micro, cand.weight_update_sharding, dp)
    model_shards = max(1, tp * pp)
    hbm = (-(-(rep.param_bytes + rep.gradient_bytes
               + rep.updater_state_bytes) // model_shards)
           + rep.activation_bytes * compute_dtype_bytes
           // max(1, census.dtype_bytes))

    # MFU charges every chip of the mesh, idle or not — a shape that
    # parks devices shows the honest utilization loss
    mfu = (census.flops_per_example * B / cand.devices
           / (step_s * hw.peak_flops)) if step_s > 0 else 0.0
    return {"step_s": step_s, "compute_s": compute_s, "comm_s": comm_s,
            "bubble": bubble, "hbm_bytes": int(hbm),
            "comm_bytes_per_step": int(comm_bytes), "mfu": mfu}
