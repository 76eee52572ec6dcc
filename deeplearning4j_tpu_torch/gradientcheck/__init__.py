"""Gradient check harness (the JAX package's ``gradientcheck/``)."""

from deeplearning4j_tpu_torch.gradientcheck.check import (  # noqa: F401
    GradientCheckUtil,
)
