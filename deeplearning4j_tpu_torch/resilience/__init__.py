"""Resilience (the JAX package's ``resilience/``): the serving errors and
deadlines, the fault-injection hooks of the generation engine and the
host-side nonfinite check. The trainers' fault tolerance, the elastic
and fleet paths wait for ROADMAP A5 (part 2) and A6."""
