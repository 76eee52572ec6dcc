"""Training-loop machinery (the JAX package's ``optimize/``): the listener
API, per-phase training telemetry and the line-search solvers."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CollectScoresIterationListener,
    ComposableIterationListener,
    IterationListener,
    ParamAndGradientIterationListener,
    PerformanceListener,
    ScoreIterationListener,
    TrainingListener,
)
