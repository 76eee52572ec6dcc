"""Metrics registry: counters, gauges, fixed-bucket histograms (the JAX
package's ``profiling/metrics.py``, whole: it imports no JAX, and the
port keeps its own copy).

Prometheus-flavored, stdlib-only. Instruments are created through a
``MetricsRegistry`` and are safe to update from any thread; the registry
renders to JSON (``to_dict()``) and to the Prometheus text exposition
format (``to_prometheus()``), which a standard scraper can poll. Histograms use FIXED bucket edges chosen at creation — cumulative
``le`` counts, exactly the Prometheus histogram contract — because
merging/aggregating across processes only works when every process
shares the same edges.

A process-global default registry (``get_registry()``) is what the
serving engine feeds.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# default seconds-scale bucket edges (compile / step / wait times)
DEFAULT_TIME_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0,
                        300.0)


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Counter:
    """Monotonically increasing value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _render(self) -> List[str]:
        return [f"{self.name} {_fmt_value(self._value)}"]

    _prom_type = "counter"

    def _json(self):
        return self._value


class Gauge:
    """Set-to-current value (watermarks, queue depths, bytes in use)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    def set_max(self, value: float) -> None:
        """Ratchet: keep the maximum ever seen (high-watermark form)."""
        with self._lock:
            self._value = max(self._value, float(value))

    @property
    def value(self) -> float:
        return self._value

    def _render(self) -> List[str]:
        return [f"{self.name} {_fmt_value(self._value)}"]

    _prom_type = "gauge"

    def _json(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram with cumulative ``le`` counts."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(
                list(buckets)):
            raise ValueError(f"bucket edges must be strictly increasing: "
                             f"{buckets}")
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le_edge, cumulative_count)] including (+Inf, total)."""
        out, acc = [], 0
        with self._lock:
            for edge, c in zip(self.buckets, self._counts):
                acc += c
                out.append((edge, acc))
            out.append((math.inf, acc + self._counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile from the cumulative buckets — the
        ``histogram_quantile`` convention: linear interpolation within
        the bucket the rank falls in (lower bound 0 for the first
        bucket), clamped to the highest finite edge when the rank lands
        in the +Inf bucket. None while the histogram is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]: {q}")
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return None
        rank = q * total
        lo, prev_cum = 0.0, 0
        for edge, c in cum:
            if c >= rank and c > prev_cum:
                if edge == math.inf:
                    # observations past the last finite edge carry no
                    # upper bound; report the last finite edge (or the
                    # lower bound when there are no finite edges)
                    return self.buckets[-1] if self.buckets else lo
                return lo + (edge - lo) * ((rank - prev_cum)
                                           / (c - prev_cum))
            if edge != math.inf:
                lo, prev_cum = edge, c
        return self.buckets[-1] if self.buckets else None

    def _render(self) -> List[str]:
        lines = []
        for edge, cum in self.cumulative():
            lines.append(
                f'{self.name}_bucket{{le="{_fmt_value(edge)}"}} {cum}')
        lines.append(f"{self.name}_sum {_fmt_value(self._sum)}")
        lines.append(f"{self.name}_count {self._count}")
        return lines

    _prom_type = "histogram"

    def _json(self):
        return {"buckets": [[e if e != math.inf else "+Inf", c]
                            for e, c in self.cumulative()],
                "sum": self._sum, "count": self._count,
                "p50": self.quantile(0.5), "p99": self.quantile(0.99)}


class LabeledCounter:
    """A counter *family*: one metric name, one child ``Counter`` per
    label set (``family.labels(reason="full").inc()``). Renders the
    standard Prometheus labeled form — one ``# TYPE`` line, one sample
    line per child. ``value`` is the sum over children, so prefix
    ``snapshot()`` views keep working on families."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], Counter] = {}

    def labels(self, **labels: str) -> Counter:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.name + _fmt_labels(dict(key)),
                                help=self.help)
                self._children[key] = child
            return child

    @property
    def value(self) -> float:
        with self._lock:
            return sum(c.value for c in self._children.values())

    def _render(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self.name}{_fmt_labels(dict(key))} "
                f"{_fmt_value(child.value)}" for key, child in items]

    _prom_type = "counter"

    def _json(self):
        with self._lock:
            items = sorted(self._children.items())
        return {_fmt_labels(dict(key)): child.value
                for key, child in items}


class LabeledGauge:
    """A gauge *family*: one metric name, one child ``Gauge`` per label
    set (``family.labels(rank="3").set(score)``). Same rendering
    contract as ``LabeledCounter``; ``remove()`` drops a child so a
    departed member (a drained fleet replica) stops exporting a stale
    sample forever. ``value`` is the sum over children so prefix
    ``snapshot()`` views keep working on families."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], Gauge] = {}

    @staticmethod
    def _key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def labels(self, **labels: str) -> Gauge:
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Gauge(self.name + _fmt_labels(dict(key)),
                              help=self.help)
                self._children[key] = child
            return child

    def remove(self, **labels: str) -> None:
        with self._lock:
            self._children.pop(self._key(labels), None)

    @property
    def value(self) -> float:
        with self._lock:
            return sum(c.value for c in self._children.values())

    def _render(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
        return [f"{self.name}{_fmt_labels(dict(key))} "
                f"{_fmt_value(child.value)}" for key, child in items]

    _prom_type = "gauge"

    def _json(self):
        with self._lock:
            items = sorted(self._children.items())
        return {_fmt_labels(dict(key)): child.value
                for key, child in items}


class MetricsRegistry:
    """Named instrument store. ``counter``/``gauge``/``histogram``/
    ``labeled_counter``/``labeled_gauge`` are get-or-create (same name
    returns the same instrument; a kind clash raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def labeled_counter(self, name: str, help: str = "") -> LabeledCounter:
        return self._get_or_create(LabeledCounter, name, help)

    def labeled_gauge(self, name: str, help: str = "") -> LabeledGauge:
        return self._get_or_create(LabeledGauge, name, help)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # --------------------------------------------------------------- exports
    def to_dict(self) -> dict:
        """JSON view: name -> value (number, or histogram dict)."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m._json() for name, m in sorted(items)}

    def snapshot(self, prefix: str = "") -> Dict[str, float]:
        """Scalar (counter/gauge) values whose name starts with
        ``prefix`` — the cheap point-in-time view failure records embed
        (a crash report can carry the ``resilience_*`` counters, its own
        fault history)."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.value for name, m in sorted(items)
                if name.startswith(prefix) and hasattr(m, "value")
                and not isinstance(m, Histogram)}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m._prom_type}")
            lines.extend(m._render())
        return "\n".join(lines) + ("\n" if lines else "")

    def timed(self, histogram_name: str, help: str = ""):
        """Context manager observing elapsed seconds into a histogram."""
        registry = self

        class _Timed:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.histogram(histogram_name, help=help).observe(
                    time.perf_counter() - self._t0)
                return False

        return _Timed()


# ---------------------------------------------------------------------------
# process-global default registry
# ---------------------------------------------------------------------------

_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry the serving engine feeds."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests). Returns the previous one."""
    global _default
    with _default_lock:
        prev, _default = _default, registry
    return prev
