"""Stats collection listener and report types (the JAX package's
``ui/stats.py``: the same reports, series names and bytes).

Role parity: BaseStatsListener gathers per-iteration score, parameter /
gradient / update histograms & norms, memory and hardware info, and routes
serialized reports to a StatsStorageRouter
(ref: deeplearning4j-ui-model/.../stats/BaseStatsListener.java:43,287-537;
init report: .../stats/impl/SbeStatsInitializationReport.java).

A report's params and gradients are copied off the card once each, as
one flat float32 buffer (``_flat_params``), and its norms and histograms
are taken on the host from there, as the JAX package takes them; the
seconds the copies took are kept in ``StatsListener.last_copy_s``. The
hardware info reads ``torch.cuda`` only where this process already
initialized CUDA.
"""

from __future__ import annotations

import platform
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.ui.codec import decode_report, encode_report


@dataclass
class StatsReport:
    """One per-iteration record (ref: SbeStatsReport.java)."""
    iteration: int
    timestamp_ms: int
    score: float
    samples_per_sec: float = 0.0
    batches_per_sec: float = 0.0
    # name → float32 vector; scalar stats are 1-element vectors, histograms
    # are "<name>#counts" / "<name>#edges" pairs.
    series: Dict[str, np.ndarray] = field(default_factory=dict)

    def encode(self) -> bytes:
        return encode_report(self.iteration, self.timestamp_ms, self.score,
                             self.samples_per_sec, self.batches_per_sec,
                             self.series)

    @staticmethod
    def decode(buf: bytes) -> "StatsReport":
        header, series = decode_report(buf)
        return StatsReport(iteration=header["iteration"],
                           timestamp_ms=header["timestamp_ms"],
                           score=header["score"],
                           samples_per_sec=header["samples_per_sec"],
                           batches_per_sec=header["batches_per_sec"],
                           series=series)

    def scalars(self, prefix: str) -> Dict[str, float]:
        return {k: float(v[0]) for k, v in self.series.items()
                if k.startswith(prefix) and v.size == 1}


@dataclass
class StatsInitializationReport:
    """Static session info sent once (ref: SbeStatsInitializationReport.java:
    hardware, software, model info)."""
    session_id: str
    timestamp_ms: int
    software: Dict[str, str] = field(default_factory=dict)
    hardware: Dict[str, str] = field(default_factory=dict)
    model: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def create(session_id: str, net=None) -> "StatsInitializationReport":
        sw = {"python": platform.python_version(),
              "os": platform.system()}
        sw["torch"] = torch.__version__
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            hw = {"backend": "cuda",
                  "device_count": str(torch.cuda.device_count()),
                  "device_kind": torch.cuda.get_device_name()}
        else:
            hw = {"backend": "cpu", "device_count": "1",
                  "device_kind": platform.machine() or "cpu"}
        model = {}
        if net is not None:
            try:
                model = {"class": type(net).__name__,
                         "n_layers": str(len(getattr(net, "layers", []))),
                         "n_params": str(net.num_params())}
            except Exception:
                model = {"class": type(net).__name__}
        return StatsInitializationReport(
            session_id=session_id, timestamp_ms=int(time.time() * 1000),
            software=sw, hardware=hw, model=model)


def _flat_params(params) -> Dict[str, np.ndarray]:
    """Flatten the per-layer param dicts (a list by layer index, or a dict
    by node name) into 'layer.name' float32 host arrays. The tensors are
    joined on their device and copied to the host once."""
    if params is None:
        return {}
    items = (params.items() if isinstance(params, dict)
             else ((str(i), d) for i, d in enumerate(params)))
    named = [(f"{key}.{name}", t) for key, d in items
             for name, t in d.items()]
    if not named:
        return {}
    flat = torch.cat([t.detach().reshape(-1).float()
                      for _, t in named]).cpu().numpy()
    out, pos = {}, 0
    for name, t in named:
        out[name] = flat[pos:pos + t.numel()].reshape(tuple(t.shape))
        pos += t.numel()
    return out


class StatsListener(TrainingListener):
    """Collects per-iteration stats into a StatsStorage router.

    What it gathers (ref: BaseStatsListener.java:287-537): score, wall time,
    throughput, parameter norms, update norms (delta of params between
    iterations — the applied update, same quantity the reference charts as
    "Update:Parameter Ratio"), gradient norms when the model exposes its
    last gradients, and (every `histogram_frequency` iterations) parameter
    histograms.
    """

    # tells the network's train step to keep its gradients in
    # ``last_grads`` (networks check this via getattr; keeps nn/ free of
    # ui imports)
    collects_gradients = True

    def __init__(self, storage, session_id: Optional[str] = None,
                 frequency: int = 1, histogram_frequency: int = 0,
                 n_bins: int = 20):
        self.storage = storage
        self.session_id = session_id or f"session-{int(time.time()*1000)}"
        self.frequency = max(1, frequency)
        self.histogram_frequency = histogram_frequency  # 0 = never
        self.n_bins = n_bins
        self._prev_params: Optional[Dict[str, np.ndarray]] = None
        self._last_time: Optional[float] = None
        self._init_sent = False
        self._skipped = 0  # iterations since last report
        #: seconds the last report's device-to-host copies took
        self.last_copy_s = 0.0

    # ------------------------------------------------------------ collection
    def iteration_done(self, model, iteration: int, score: float) -> None:
        if not self._init_sent:
            self.storage.put_init_report(
                StatsInitializationReport.create(self.session_id, model))
            self._init_sent = True
        now = time.perf_counter()
        if iteration % self.frequency != 0:
            # no device→host transfer on skipped iterations; update norms
            # are computed over the whole reporting interval
            self._skipped += 1
            return
        t_copy = time.perf_counter()
        flat = _flat_params(getattr(model, "params", None))
        grads = _flat_params(getattr(model, "last_grads", None))
        self.last_copy_s = time.perf_counter() - t_copy
        series: Dict[str, np.ndarray] = {}
        sps = bps = 0.0
        interval = self._skipped + 1
        if self._last_time is not None:
            dt = now - self._last_time
            if dt > 0:
                batch = getattr(model, "last_batch_size", 0) or 0
                sps = batch * interval / dt
                bps = interval / dt
        for name, arr in flat.items():
            series[f"param_norm:{name}"] = np.array(
                [np.linalg.norm(arr)], np.float32)
            if self._prev_params is not None and name in self._prev_params \
                    and self._prev_params[name].shape == arr.shape:
                upd = arr - self._prev_params[name]
                un = float(np.linalg.norm(upd))
                series[f"update_norm:{name}"] = np.array([un], np.float32)
                pn = float(np.linalg.norm(arr))
                if pn > 0:
                    series[f"ratio:{name}"] = np.array([un / pn], np.float32)
        for name, arr in grads.items():
            series[f"grad_norm:{name}"] = np.array(
                [np.linalg.norm(arr)], np.float32)
        if self.histogram_frequency and \
                iteration % self.histogram_frequency == 0:
            for name, arr in flat.items():
                counts, edges = np.histogram(arr, bins=self.n_bins)
                series[f"hist_param:{name}#counts"] = counts.astype(np.float32)
                series[f"hist_param:{name}#edges"] = edges.astype(np.float32)
            for name, arr in grads.items():
                counts, edges = np.histogram(arr, bins=self.n_bins)
                series[f"hist_grad:{name}#counts"] = counts.astype(np.float32)
                series[f"hist_grad:{name}#edges"] = edges.astype(np.float32)
        self._mem_stats(series)
        report = StatsReport(iteration=iteration,
                             timestamp_ms=int(time.time() * 1000),
                             score=float(score), samples_per_sec=sps,
                             batches_per_sec=bps, series=series)
        self.storage.put_report(self.session_id, report)
        self._prev_params = flat
        self._last_time = now
        self._skipped = 0

    @staticmethod
    def _mem_stats(series: Dict[str, np.ndarray]) -> None:
        try:
            import resource
            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            series["mem:host_rss_mb"] = np.array([rss_kb / 1024.0], np.float32)
        except Exception:
            pass
        try:
            # shared memory_stats probe (profiling/watchers.py): the
            # same one the DeviceMemoryWatermark sampler polls; None on
            # the CPU
            from deeplearning4j_tpu_torch.profiling.watchers import (
                device_memory_stats)
            ms = device_memory_stats()
            if ms and "bytes_in_use" in ms:
                series["mem:device_mb"] = np.array(
                    [ms["bytes_in_use"] / 2**20], np.float32)
        except Exception:
            pass
