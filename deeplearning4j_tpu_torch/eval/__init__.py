"""Evaluation (the JAX package's ``eval/``): classification, ROC / AUC
and regression metrics, all on host numpy."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
from deeplearning4j_tpu_torch.eval.regression import (  # noqa: F401
    RegressionEvaluation,
)
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass  # noqa: F401
