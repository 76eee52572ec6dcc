"""Profiling (the JAX package's ``profiling/``): the span tracer, the
metrics registry, the flight recorder, and the watchdog's heartbeats and
diagnostic bundle, the parts the serving edge emits into. The cost
analysis and the compile watchers wait for ROADMAP A7, ``StallWatchdog``
for A5.3."""
