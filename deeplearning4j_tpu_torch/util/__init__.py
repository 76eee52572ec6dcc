"""Utilities (the JAX package's ``util/``): the ``ModelSerializer`` zip
checkpoints, and the host numpy helpers ``math_utils``, ``time_series``
and ``Viterbi`` / ``viterbi_decode``."""

from deeplearning4j_tpu_torch.util.serializer import (  # noqa: F401
    ModelSerializer,
)
from deeplearning4j_tpu_torch.util.viterbi import (  # noqa: F401
    Viterbi, viterbi_decode,
)
from deeplearning4j_tpu_torch.util import math_utils, time_series  # noqa: F401
