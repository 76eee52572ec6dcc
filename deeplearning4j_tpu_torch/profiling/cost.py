"""A training step's cost: FLOPs, bytes accessed, analytic MFU (the JAX
package's ``profiling/cost.py``).

The JAX package reads XLA's compile-time cost model. PyTorch has none, so
``train_step_cost`` counts one real forward and backward of the net's
loss on its own device under ``torch.utils.flop_counter.FlopCounterMode``
and adds what the hand-written kernels did. The counter sees aten ops
only; K1-K6 launch through ``ctypes`` and are invisible to it. So each
kernel wrapper reports its FLOP formula through :func:`count_kernel_flops`
when it launches: the count its plain version gives under the same
counter at the same shapes (full ``T x T`` products for causal attention,
the backward's recompute of P). The count is therefore the same on the
card and on the CPU, whichever path runs.

``weight_update_cost(net, dp, ...)`` models the data-parallel trainers'
weight-update traffic and per-rank updater-state / gradient bytes for the
three layouts (replicated, ``zero1``, ``zero2``).
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

# Peak dense matmul FLOP/s per device, by device-kind substring; the
# first match wins. The H100 row is NVIDIA's published dense figure for
# the H100 SXM5 (bf16 tensor cores, 989.4 TFLOP/s), not a measurement;
# its f32 products run as 3xTF32 (H100_TF32_FLOPS / 3). The TPU rows are
# the JAX package's data. "cpu" is a nominal 1 TFLOP/s, so that a CPU
# run has a defined ratio: a relative number, not a utilization.
H100_BF16_FLOPS = 989.4e12
H100_TF32_FLOPS = 494.7e12
H100_FP32_FLOPS = 66.9e12      # CUDA cores
PEAK_FLOPS_PER_CHIP = (
    ("h100", H100_BF16_FLOPS),
    ("v6", 918e12),
    ("v5p", 459e12),
    ("v5 lite", 197e12),
    ("v5litepod", 197e12),
    ("v5e", 197e12),
    ("v4", 275e12),
    ("v3", 123e12),
    ("v2", 45e12),
    ("cpu", 1e12),
)


def peak_flops(device_kind: str) -> Optional[float]:
    """Peak FLOP/s for a device-kind string (substring match), or None
    when the device is unknown."""
    kind = (device_kind or "").lower()
    for key, peak in PEAK_FLOPS_PER_CHIP:
        if key in kind:
            return peak
    return None


def analytic_mfu(flops_per_step: float, step_seconds: float,
                 peak_flops_per_chip: float, n_chips: int = 1
                 ) -> Optional[float]:
    """Model FLOPs utilization: achieved FLOP/s over peak, ``n_chips``
    sharing the step's FLOPs."""
    if not flops_per_step or not step_seconds or not peak_flops_per_chip:
        return None
    if step_seconds <= 0 or peak_flops_per_chip <= 0:
        return None
    return flops_per_step / (step_seconds * peak_flops_per_chip
                             * max(n_chips, 1))


# ---------------------------------------------------------------------------
# the kernels' FLOPs
# ---------------------------------------------------------------------------

_KERNEL_SINKS: List[Dict[str, float]] = []


def count_kernel_flops(name: str, flops: float) -> None:
    """Called by a kernel wrapper when it launches its kernel: adds the
    kernel's FLOPs to every count in progress (:func:`counting_kernels`)."""
    for sink in _KERNEL_SINKS:
        sink[name] = sink.get(name, 0.0) + float(flops)


class counting_kernels:
    """``with counting_kernels() as flops:`` collects the FLOPs the kernel
    wrappers report while the block runs, by kernel name."""

    def __enter__(self) -> Dict[str, float]:
        self._sink: Dict[str, float] = {}
        _KERNEL_SINKS.append(self._sink)
        return self._sink

    def __exit__(self, *exc) -> None:
        _KERNEL_SINKS.remove(self._sink)


# ---------------------------------------------------------------------------
# data-parallel weight-update cost model (replicated vs zero1 / zero2)
# ---------------------------------------------------------------------------

def dp_comm_bytes_per_update(param_count: int, dp: int,
                             dtype_bytes: int = 4,
                             gradient_accumulation: int = 1,
                             weight_update_sharding: str = "off") -> int:
    """Bytes a rank moves per optimizer update on the ring model (an
    all-reduce moves ``2 (dp-1)/dp`` of the payload a rank, a
    reduce-scatter or an all-gather ``(dp-1)/dp``). ``off``: one gradient
    all-reduce a microbatch, ``k 2 (dp-1)/dp P b``; ``zero1`` / ``zero2``:
    a reduce-scatter a microbatch and one param all-gather an update,
    ``(k+1) (dp-1)/dp P b``. 0 at dp = 1."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        SHARDED_WUS_MODES,
    )
    dp = max(1, int(dp))
    if dp == 1:
        return 0
    k = max(1, int(gradient_accumulation))
    payload = int(param_count) * int(dtype_bytes)
    unit = payload * (dp - 1) // dp
    if weight_update_sharding in SHARDED_WUS_MODES:
        return (k + 1) * unit
    return 2 * k * unit


def dp_updater_hbm_bytes(param_count: int, updater: str, dp: int,
                         dtype_bytes: int = 4,
                         weight_update_sharding: str = "off") -> int:
    """A rank's standing updater-state bytes: ``slots P b`` replicated,
    divided by ``dp`` under zero1 / zero2."""
    from deeplearning4j_tpu_torch.analysis.graphcheck import (
        SHARDED_WUS_MODES,
    )
    from deeplearning4j_tpu_torch.analysis.memory import UPDATER_STATE_SLOTS
    slots = UPDATER_STATE_SLOTS.get((updater or "").lower(), 2)
    total = int(param_count) * int(dtype_bytes) * slots
    if weight_update_sharding in SHARDED_WUS_MODES and dp > 1:
        return -(-total // int(dp))
    return total


def dp_gradient_hbm_bytes(param_count: int, dp: int,
                          dtype_bytes: int = 4,
                          weight_update_sharding: str = "off") -> int:
    """A rank's bytes of the reduced gradient the update consumes: ``P b``
    under ``off`` and ``zero1`` (its replicated anchor), ``P b / dp``
    under ``zero2``."""
    total = int(param_count) * int(dtype_bytes)
    if weight_update_sharding == "zero2" and dp > 1:
        return -(-total // int(dp))
    return total


# Per-net caches, keyed on the net weakly (nothing in a value reaches the
# net, or the key never dies): an autotune sweep asks for the same
# census once a candidate.
_PARAM_CENSUS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_STEP_COST: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def param_census(net) -> dict:
    """{param_count, dtype_bytes, updater} of an initialized container,
    memoized on the net's identity. The returned dict is the cached one:
    read-only."""
    try:
        cached = _PARAM_CENSUS.get(net)
    except TypeError:
        cached = None
    if cached is not None:
        return cached
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    leaves = tree_leaves(net.params)
    census = {
        "param_count": sum(t.numel() for t in leaves),
        "dtype_bytes": leaves[0].element_size() if leaves else 4,
        "updater": net.conf.training.updater.name,
    }
    try:
        _PARAM_CENSUS[net] = census
    except TypeError:
        pass
    return census


def _batch_signature(batch) -> tuple:
    """Hashable (shapes, dtypes) of a DataSet / MultiDataSet."""
    import numpy as np

    def sig(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return tuple(sorted((k, sig(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        return (tuple(np.shape(x)), str(getattr(x, "dtype", None)
                                        or np.asarray(x).dtype))

    return tuple(sig(getattr(batch, k, None)) for k in
                 ("features", "labels", "features_mask", "labels_mask",
                  "features_masks", "labels_masks"))


def weight_update_cost(net, dp: int, gradient_accumulation: int = 1,
                       weight_update_sharding: str = "off") -> dict:
    """The weight-update cost fields of an initialized container at data
    parallelism ``dp`` and a layout: bytes a rank moves an update, its
    updater-state and gradient bytes. Metadata only (the memoized
    :func:`param_census`)."""
    census = param_census(net)
    param_count = census["param_count"]
    dtype_bytes = census["dtype_bytes"]
    updater = census["updater"]
    return {
        "weight_update_sharding": weight_update_sharding,
        "dp": int(dp),
        "gradient_accumulation": int(gradient_accumulation),
        "comm_bytes_per_step": dp_comm_bytes_per_update(
            param_count, dp, dtype_bytes, gradient_accumulation,
            weight_update_sharding),
        "updater_hbm_bytes": dp_updater_hbm_bytes(
            param_count, updater, dp, dtype_bytes, weight_update_sharding),
        "gradient_hbm_bytes": dp_gradient_hbm_bytes(
            param_count, dp, dtype_bytes, weight_update_sharding),
    }


def _step_key(net) -> tuple:
    """What a rebuilt step changes: the precision policy, remat, the
    sentinel and the updater. A cached cost whose key differs is stale."""
    t = net.conf.training
    sentinel = getattr(net, "_sentinel", None)
    return (str(t.precision), t.loss_scale, bool(t.remat),
            None if sentinel is None else id(sentinel), t.updater.name)


def _count_step(net, batch) -> tuple:
    """(FLOPs, saved-activation bytes) of one forward and backward of the
    net's loss on ``batch``: the aten ops FlopCounterMode sees plus the
    kernels' formulas, and the bytes of the tensors autograd saves for
    the backward (each storage once). Leaves the net as it found it: no
    update runs, and the dropout stream is put back."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    saved: Dict[int, int] = {}

    def pack(t):
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            try:
                st = t.untyped_storage()
                saved[st.data_ptr()] = st.nbytes()
            except (RuntimeError, NotImplementedError):
                pass
        return t

    rng = getattr(net, "_rng", None)
    rng_state = rng.get_state() if rng is not None else None
    try:
        with counting_kernels() as kernel_flops, \
                FlopCounterMode(display=False) as counter, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            net.compute_gradient_and_score(batch)
    finally:
        if rng is not None:
            rng.set_state(rng_state)
    return (float(counter.get_total_flops()) + sum(kernel_flops.values()),
            float(sum(saved.values())))


def _batch_bytes(batch) -> float:
    """Bytes of a DataSet's / MultiDataSet's arrays."""
    import numpy as np
    total = 0
    for k in ("features", "labels", "features_mask", "labels_mask",
              "features_masks", "labels_masks"):
        v = getattr(batch, k, None)
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if x is not None:
                total += np.asarray(x).nbytes
    return float(total)


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` for a CUDA device, else "cpu"."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def train_step_cost(net, batch, peak: Optional[float] = None) -> dict:
    """The cost of a container's training step on ``batch``:
    {flops_per_step, flops_per_example, bytes_accessed,
    arithmetic_intensity, comm_bytes_hlo, batch, device_kind,
    peak_flops_per_chip}.

    FLOPs: one forward and backward of the loss on the net's device (see
    the module docstring; the update's elementwise work is not counted,
    as the counter counts products). Bytes accessed, the model: the
    params are read by the forward and the backward and read and written
    by the update (4 P b); the gradients written by the backward and read
    by the update (2 P b); each updater moment read and written (2 K P b);
    the tensors autograd saves written by the forward and read by the
    backward (2 A, each storage once); the batch read once.
    ``comm_bytes_hlo`` is None: no compiled program is parsed.

    Memoized on (the net, weakly; the batch signature; ``peak``). An entry
    is dropped when the net's step changes (its precision, remat, sentinel
    or updater)."""
    net._check_init()
    cache_key = (_batch_signature(batch), peak)
    step_key = _step_key(net)
    try:
        entry = _STEP_COST.get(net)
    except TypeError:
        entry = None
    if entry is not None and entry[0] != step_key:
        entry = None
    hit = entry[1].get(cache_key) if entry is not None else None
    if hit is not None:
        return dict(hit)
    from deeplearning4j_tpu_torch.analysis.memory import UPDATER_STATE_SLOTS
    flops, saved = _count_step(net, batch)
    census = param_census(net)
    pb = census["param_count"] * census["dtype_bytes"]
    slots = UPDATER_STATE_SLOTS.get(census["updater"].lower(), 2)
    bytes_accessed = (4 + 2 + 2 * slots) * pb + 2 * saved \
        + _batch_bytes(batch)
    n_examples = batch.num_examples()
    kind = device_kind(net.device)
    peak = peak if peak is not None else peak_flops(kind)
    out = {
        "flops_per_step": flops,
        "flops_per_example": flops / n_examples if n_examples else None,
        "bytes_accessed": bytes_accessed,
        "comm_bytes_hlo": None,
        "arithmetic_intensity": (flops / bytes_accessed
                                 if bytes_accessed else None),
        "batch": n_examples,
        "device_kind": kind,
        "peak_flops_per_chip": peak,
    }
    try:
        if entry is None:
            entry = (step_key, {})
            _STEP_COST[net] = entry
        entry[1][cache_key] = dict(out)
    except TypeError:
        pass
    return out
