"""Profiling (the JAX package's ``profiling/``): the span tracer, the
metrics registry, the flight recorder and the watchdog's heartbeats, the
parts the serving engine emits into. The cost analysis, the compile
watchers and ``StallWatchdog`` are not ported yet (ROADMAP A7)."""
