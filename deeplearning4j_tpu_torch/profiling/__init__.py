"""Profiling (the JAX package's ``profiling/``): the span tracer, the
metrics registry, the flight recorder, and the watchdog — its heartbeats,
the diagnostic bundle and the ``StallWatchdog`` that writes one when a
heartbeat goes stale. The cost analysis and the compile watchers wait
for ROADMAP A7."""

from deeplearning4j_tpu_torch.profiling.watchdog import (  # noqa: F401
    StallWatchdog, assemble_bundle, beat, heartbeat_ages,
)
