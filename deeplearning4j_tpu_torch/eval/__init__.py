"""Evaluation (the JAX package's ``eval/``; so far classification)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
