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

#: the package's names, loaded on first use: a submodule that needs no
#: torch (the source lints, the analysis umbrella) starts without it
_EXPORTS = {"InputType": "nn.conf", "MultiLayerConfiguration": "nn.conf",
            "NeuralNetConfiguration": "nn.conf",
            "ComputationGraph": "nn.graph",
            "MultiLayerNetwork": "nn.multilayer"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
