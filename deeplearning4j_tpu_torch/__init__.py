"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

It mirrors the JAX package's module layout and names, so each counterpart
is found at the same path, and it imports nothing of that package. Plain
tensor code is PyTorch; every TPU (Pallas) kernel on a ported path is a
hand-written Hopper kernel under ``csrc/``, built with nvcc on first use.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.
``util.serializer.ModelSerializer`` saves and restores either container
in the JAX package's zip format, so checkpoints cross in both directions.
"""

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.nn.conf import (  # noqa: F401
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: F401
    MultiLayerNetwork,
)
