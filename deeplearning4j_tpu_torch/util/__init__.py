"""Utilities (the JAX package's ``util/``): ``math_utils`` and the
``ModelSerializer`` zip checkpoints."""

from deeplearning4j_tpu_torch.util.serializer import (  # noqa: F401
    ModelSerializer,
)
